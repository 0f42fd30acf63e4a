"""ILS/ICM encoding for fully-connected MCQ (LSQ / LSQ++).

Equivalent of the reference's three ICM implementations — Julia
``iterated_conditional_modes!`` (`src/LSQ.jl:83-149`), C++ ``condition``
(`deps/src/encode_icm.cpp:3-61`), and the CUDA stack ``perturb`` /
``condition_icm3`` / ``veccost2`` (`deps/src/cudautils.cu:27-80,
334-437, 85-183`) — as one batched, jit-compiled formulation:

* unaries for a chunk come from one (nc, d) x (d, m*h) matmul;
* one ICM conditioning step for node i needs, for every h label b,
  ``sum_{j != i} bin[i, j][b, B_j]``. Two forms compute it:

  - ``form="running"`` (default): with ``S = sum_j C_j[B_j]`` the
    conditional is ``u_i(b) + 2 C_i[b] . (S - C_i[B_i])`` — one
    (nc, d) x (d, h) matmul per visit, 2*d*h FLOPs per vector instead
    of the table form's m*h^2 (8x fewer at m=8, h=256, d=128), and no
    m^2 tables; S is updated in place after each visit;
  - ``form="table"``: the reference's precomputed (m*h, h) binary
    tables per node, gathered with a one-hot (nc, m*h) matmul;

* the ILS wrapper perturbs ``npert`` positions per vector (sampled
  with replacement, matching ``perturb_codes!`` `src/LSQ.jl:5-39`),
  draws ONE random node order per ILS round shared by all vectors
  (`src/LSQ.jl:218-221`), runs ``icmiter`` sweeps, and accepts per
  vector only strictly-better codes (`src/LSQ.jl:240-248`), judged on
  the exact f32 energy, so an encode is never worse than its input.

Vectors stream in fixed-size chunks (the reference GPU's ``nsplits``
memory tiling, `src/LSQ_GPU.jl:218-264`). PRNG is explicit threefry key
threading — statistical, not bitwise, parity with the reference's
global RNGs (SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu import platform
from rayuela_tpu.ops.qerror import get_binaries, reconstruct
from rayuela_tpu.utils import cdiv

Array = jax.Array


def _chunk_energy(u: Array, Bin: Array, B: Array) -> Array:
    """Exact MRF energy per vector, up to the constant |x|^2:
    sum_i u_i(B_i) + sum_{i<j} bin[i,j][B_i, B_j]. ``u``: (m, nc, h),
    ``Bin``: (m, m, h, h) with diagonal zero, ``B``: (nc, m)."""
    m, nc, h = u.shape
    un = jnp.sum(jnp.take_along_axis(
        u, jnp.transpose(B)[:, :, None], axis=2)[:, :, 0], axis=0)
    # pairwise: gather bin[i, j][B_i, B_j] for all pairs (diag is zero);
    # each unordered pair is counted twice, hence the 0.5
    flat = Bin.reshape(m, m, h * h)
    pair_idx = B[:, :, None] * h + B[:, None, :]          # (nc, m, m)
    g = jax.vmap(lambda pi: flat[jnp.arange(m)[:, None],
                                 jnp.arange(m)[None, :],
                                 pi])(pair_idx)           # (nc, m, m)
    return un + 0.5 * jnp.sum(g, axis=(1, 2))


def _icm_sweeps(u: Array, T: Array, B: Array, order: Array,
                icmiter: int) -> Array:
    """``icmiter`` ICM sweeps over all m nodes in ``order``.

    ``u``: (m, nc, h) unaries; ``T``: (m, m*h, h) where
    ``T[i, j*h + a, b] = bin[j, i][a, b]`` (the conditioning tables for
    node i, diagonal block zeroed); ``B``: (nc, m) current codes.

    The conditioning gather ``sum_j T[i, j*h + B_j]`` is expressed as a
    one-hot (nc, m*h) x (m*h, h) matmul at the table dtype
    (`_table_dtype`); the one-hot operand is exact either way.
    """
    m, nc, h = u.shape
    tdt = T.dtype

    def node_step(t, B):
        i = order[t]
        Ti = lax.dynamic_index_in_dim(T, i, 0, keepdims=False)  # (mh, h)
        oh = jax.nn.one_hot(B, h, dtype=tdt).reshape(nc, m * h)
        cond = lax.dynamic_index_in_dim(u, i, 0, keepdims=False) \
            + jnp.matmul(oh, Ti, preferred_element_type=jnp.float32)
        newb = jnp.argmin(cond, axis=-1).astype(B.dtype)  # (nc,)
        return jnp.where(jnp.arange(m)[None, :] == i, newb[:, None], B)

    def sweep(_, B):
        return lax.fori_loop(0, m, node_step, B)

    return lax.fori_loop(0, icmiter, sweep, B)


def _icm_sweeps_running(u: Array, C: Array, B: Array, order: Array,
                        icmiter: int, dtype) -> tuple[Array, Array]:
    """``icmiter`` ICM sweeps in the running-sum form. ``u``: (m, nc, h)
    unaries; ``C``: (m, h, d) f32; ``B``: (nc, m). Returns the codes
    and their reconstruction ``S (nc, d) = sum_j C_j[B_j]``.

    The conditional of node i is ``u_i(b) + 2 C_i[b] . (S - C_i[B_i])``
    — the same quantity as the table form's gather (the binary terms
    are ``bin[i, j][a, b] = 2 C_i[a] . C_j[b]``). Its matmul runs at
    ``dtype`` with f32 accumulation."""
    m, nc, h = u.shape
    Cd = C.astype(dtype)
    cols = jnp.arange(m)[None, :]

    def node_step(t, state):
        B, S = state
        i = order[t]
        Ci = lax.dynamic_index_in_dim(C, i, 0, keepdims=False)   # (h, d)
        bi = lax.dynamic_index_in_dim(B, i, 1, keepdims=False)   # (nc,)
        rest = S - jnp.take(Ci, bi, axis=0)
        cond = lax.dynamic_index_in_dim(u, i, 0, keepdims=False) \
            + 2.0 * jnp.matmul(
                rest.astype(dtype),
                lax.dynamic_index_in_dim(Cd, i, 0, keepdims=False).T,
                preferred_element_type=jnp.float32)
        newb = jnp.argmin(cond, axis=-1).astype(B.dtype)          # (nc,)
        return (jnp.where(cols == i, newb[:, None], B),
                rest + jnp.take(Ci, newb, axis=0))

    def sweep(_, state):
        return lax.fori_loop(0, m, node_step, state)

    return lax.fori_loop(0, icmiter, sweep, (B, reconstruct(C, B)))


def _table_dtype():
    """Conditioning operand dtype, from `platform.operand_dtype`: bf16
    on the GPU (tensor-core rate; the binary terms round to ~3 decimal
    digits, and ICM is a stochastic local search whose acceptance uses
    the exact f32 energy, so this is statistical, not bitwise, parity),
    f32 on the CPU (tests compare against exact coordinate descent)."""
    return platform.operand_dtype()


def _perturb(key: Array, B: Array, npert: int, h: int) -> Array:
    """Perturb ``npert`` positions per vector (with replacement) to
    uniform random codes — semantics of ``perturb_codes!``
    (`src/LSQ.jl:5-39`) / CUDA ``perturb`` (`cudautils.cu:27-80`)."""
    nc, m = B.shape
    kp, kv = jax.random.split(key)
    pos = jax.random.randint(kp, (nc, npert), 0, m)       # positions
    val = jax.random.randint(kv, (nc, npert), 0, h).astype(B.dtype)
    # sequential overwrite over the npert draws (last hit wins), as in
    # the reference's scalar loop
    out = B
    for t in range(npert):
        out = jnp.where(jnp.arange(m)[None, :] == pos[:, t:t + 1],
                        val[:, t:t + 1], out)
    return out


def encoding_icm(key: Array, X: Array, C: Array, B0: Array, *,
                 ilsiter: int = 8, icmiter: int = 4, npert: int = 4,
                 randord: bool = True, chunk: int = 8192,
                 form: str = "running") -> Array:
    """ILS-over-ICM encoding. Returns improved codes ``(n, m) int32``.

    Reference ``encoding_icm`` / ``encode_icm_fully!``
    (`src/LSQ.jl:152-294`); defaults are the reference experiment
    settings (`demos/demos_train_query_base.jl:64-67`). ``form``
    picks the conditioning form (module docstring)."""
    if form not in ("running", "table"):
        raise ValueError(f"form {form!r}: 'running' or 'table'")
    return _encoding_icm_xla(key, X, C, B0, ilsiter=ilsiter,
                             icmiter=icmiter, npert=npert,
                             randord=randord, chunk=chunk, form=form)


def _ils_schedule(key: Array, m: int, ilsiter: int, randord: bool):
    """Per-round perturbation keys + node orders."""
    keys = jax.random.split(key, ilsiter + 1)
    if randord:
        orders = jnp.stack([jax.random.permutation(keys[t + 1], m)
                            for t in range(ilsiter)]).astype(jnp.int32)
    else:
        orders = jnp.tile(jnp.arange(m, dtype=jnp.int32), (ilsiter, 1))
    pkeys = jnp.stack([jax.random.fold_in(keys[0], t)
                       for t in range(ilsiter)])
    return pkeys, orders


@partial(jax.jit, static_argnames=("ilsiter", "icmiter", "npert",
                                   "randord", "chunk", "form"))
def _encoding_icm_xla(key: Array, X: Array, C: Array, B0: Array, *,
                      ilsiter: int = 8, icmiter: int = 4, npert: int = 4,
                      randord: bool = True, chunk: int = 8192,
                      form: str = "running") -> Array:
    n, d = X.shape
    m, h, _ = C.shape
    nchunks = cdiv(n, chunk)
    pad = nchunks * chunk - n
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    Bp = jnp.pad(B0.astype(jnp.int32), ((0, pad), (0, 0)))
    c2 = jnp.sum(C * C, axis=-1)                          # (m, h)
    dt = _table_dtype()
    if form == "table":
        Bin = get_binaries(C)                             # (m, m, h, h)
        eye = jnp.eye(m, dtype=Bin.dtype)
        Bin = Bin * (1.0 - eye)[:, :, None, None]         # zero diagonal
        # conditioning tables for node i: T[i] stacks bin[j, i] over j
        T = jnp.transpose(Bin, (1, 0, 2, 3)).reshape(m, m * h, h)
        T = T.astype(dt)

    # one ILS schedule (perturb keys + node orders) shared by all chunks
    pkeys, orders = _ils_schedule(key, m, ilsiter, randord)

    def encode_chunk(args):
        Xc, Bc, ci = args
        # unaries at the default matmul precision: ICM only ranks
        # labels with them; acceptance below uses exact energies
        u = c2[:, None, :] - 2.0 * jnp.einsum(
            "nd,mhd->mnh", Xc, C, preferred_element_type=jnp.float32)

        if form == "table":
            def ils_round(t, B):
                prev = _chunk_energy(u, Bin, B)
                kb = jax.random.fold_in(pkeys[t], ci)
                Bt = _perturb(kb, B, npert, h)
                Bt = _icm_sweeps(u, T, Bt, orders[t], icmiter)
                new = _chunk_energy(u, Bin, Bt)
                return jnp.where((new < prev)[:, None], Bt, B)

            return lax.fori_loop(0, ilsiter, ils_round, Bc)

        def energy(S):                  # exact |x - x_hat|^2, f32
            return jnp.sum((Xc - S) ** 2, axis=-1)

        def ils_round_running(t, state):
            B, E = state
            kb = jax.random.fold_in(pkeys[t], ci)
            Bt = _perturb(kb, B, npert, h)
            Bt, _ = _icm_sweeps_running(u, C, Bt, orders[t], icmiter, dt)
            # fresh f32 decode: the running S drifts by summation order
            Et = energy(reconstruct(C, Bt))
            keep = Et < E
            return jnp.where(keep[:, None], Bt, B), jnp.minimum(Et, E)

        B, _ = lax.fori_loop(0, ilsiter, ils_round_running,
                             (Bc, energy(reconstruct(C, Bc))))
        return B

    Xcs = Xp.reshape(nchunks, chunk, d)
    Bcs = Bp.reshape(nchunks, chunk, m)
    out = lax.map(encode_chunk,
                  (Xcs, Bcs, jnp.arange(nchunks, dtype=jnp.int32)))
    return out.reshape(-1, m)[:n]


def encoding_icm_checkpoints(key: Array, X: Array, C: Array, B0: Array,
                             ilsiters=(16, 32, 64), **kw
                             ) -> list[Array]:
    """Snapshot the codes after several cumulative ILS budgets.

    Equivalent of the reference CUDA encoder's multi-checkpoint mode
    (`src/LSQ_GPU.jl:193-204`), used by the high-recall sweeps
    (`demos/demos_train_query_base.jl:98-158`, ilsiters in {1..256}).
    ILS is sequential, so each snapshot continues from the previous one;
    PRNG streams differ from a single long run (statistical parity).
    """
    ilsiters = sorted(ilsiters)
    outs, B, done = [], B0, 0
    for i, target in enumerate(ilsiters):
        gap = target - done
        if gap > 0:
            B = encoding_icm(jax.random.fold_in(key, i), X, C, B,
                             ilsiter=gap, **kw)
            done = target
        outs.append(B)
    return outs
