"""Least-squares codebook update: given fixed codes, solve for codebooks.

Equivalent of reference `src/codebook_update.jl` — the LSQ-family inner
step ``min_C ||X - B_tilde @ C||^2`` where ``B_tilde`` is the (n, m*h)
binary indicator of the codes. The reference offers five methods
(``naive`` dense backslash :47-60, ``fast`` regularized normal
equations :63-93, ``fastbin`` histogram-built normal equations + LU
:96-229, LSQR/LSMR per-dimension iterative solves farmed to Distributed
workers :235-278) plus chain-restricted variants (:280-412).

TPU-native design: the normal-equation statistics are the whole game —

    G = B_tilde^T B_tilde   (mh, mh)   co-occurrence counts
    F = B_tilde^T X         (mh, d)    per-entry data sums

The reference builds G by scalar histogram loops over n (its ``fastbin``
trick, `:96-171`). Here both are **one-hot matmuls on the MXU**, chunked
over n with a `lax.fori_loop` so the (chunk, mh) one-hot never exceeds a
few hundred MB, and — crucially for the device mesh — G and F are plain
sums over n, so with X/B sharded on the ``data`` axis GSPMD reduces them
with one `psum` (SURVEY.md §2.5: "dimension-parallel LSQR solves" →
"replicated normal-equation solve after psum of statistics").

The solve itself is a (mh, mh) LU/Cholesky — microseconds at m=16 —
replicated on every device. Iterative methods (lsqr/lsmr) are provided
as matrix-free CG on the same normal equations for capability parity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu.utils import cdiv, splitarray

Array = jax.Array


def _pad_chunked(X: Array, B: Array, chunk: int) -> tuple[Array, Array, int]:
    """Pad n to a multiple of ``chunk``; padded codes become -1 so their
    one-hot rows are all-zero (jax.nn.one_hot semantics) and contribute
    nothing to the statistics."""
    n = X.shape[0]
    nchunks = cdiv(n, chunk)
    pad = nchunks * chunk - n
    if pad:
        X = jnp.pad(X, ((0, pad), (0, 0)))
        B = jnp.pad(B, ((0, pad), (0, 0)), constant_values=-1)
    return X, B, nchunks


@partial(jax.jit, static_argnames=("h", "chunk"))
def codebook_stats(X: Array, B: Array, h: int = 256,
                   chunk: int = 16384) -> tuple[Array, Array]:
    """Accumulate ``(G, F)`` normal-equation statistics.

    Reference ``fast_bin_matmul`` (`src/codebook_update.jl:96-171`)
    builds these with per-element histogram loops; here each chunk is
    two MXU matmuls on an exact {0,1} one-hot."""
    n, d = X.shape
    m = B.shape[1]
    mh = m * h
    X, B, nchunks = _pad_chunked(X, B, chunk)

    def body(i, state):
        G, F = state
        Xc = lax.dynamic_slice_in_dim(X, i * chunk, chunk)
        Bc = lax.dynamic_slice_in_dim(B, i * chunk, chunk)
        U = jax.nn.one_hot(Bc, h, dtype=jnp.float32).reshape(chunk, mh)
        # G is exact at any precision (0/1 products, f32 accumulation);
        # F needs HIGHEST or a TF32/bf16 pass rounds X's values
        G = G + jnp.matmul(U.T, U, preferred_element_type=jnp.float32)
        F = F + jnp.matmul(U.T, Xc, preferred_element_type=jnp.float32,
                           precision=lax.Precision.HIGHEST)
        return G, F

    G0 = jnp.zeros((mh, mh), jnp.float32)
    F0 = jnp.zeros((mh, d), jnp.float32)
    return lax.fori_loop(0, nchunks, body, (G0, F0))


@partial(jax.jit, static_argnames=("h", "rho"))
def _solve_direct(G: Array, F: Array, h: int, rho: float) -> Array:
    """Ridge solve of the normal equations.

    Two numerical guards both matter on TPU (without them the solve
    intermittently explodes at protocol scale — observed 9.4 -> 5e11
    qerror in one update): the LU factorization must run at HIGHEST
    matmul precision (the default single-bf16-pass matmul cannot
    factor a cond ~n/rho matrix; G is near-singular by construction —
    each codebook's one-hot columns sum to the same all-ones vector),
    and the ridge must scale with G (counts grow with n, so an
    absolute 1e-4 vanishes relative to diag ~n/h)."""
    mh, d = F.shape
    m = mh // h
    scale = jnp.maximum(jnp.mean(jnp.diagonal(G)), 1.0)
    A = G + (rho * scale) * jnp.eye(mh, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        C = jnp.linalg.solve(A, F)           # (mh, d)
    return C.reshape(m, h, d)


def _solve_cg(G: Array, F: Array, h: int, rho: float, maxiter: int) -> Array:
    """Matrix-free CG on the (ridged) normal equations — the TPU
    equivalent of the reference's per-dimension LSQR/LSMR farmed to
    Distributed workers (`src/codebook_update.jl:235-278`): all d
    right-hand sides solve in one batched CG instead. Same precision /
    relative-ridge guards as `_solve_direct` (bf16-pass matvecs stall
    CG on ill-conditioned G)."""
    mh, d = F.shape
    m = mh // h
    scale = jnp.maximum(jnp.mean(jnp.diagonal(G)), 1.0)
    A = G + (rho * scale) * jnp.eye(mh, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        C, _ = jax.scipy.sparse.linalg.cg(lambda v: A @ v, F,
                                          maxiter=maxiter)
    return C.reshape(m, h, d)


def update_codebooks(X: Array, B: Array, h: int = 256,
                     method: str = "fastbin", rho: float = 1e-4,
                     chunk: int = 16384) -> Array:
    """Full-dimensional codebook update → ``C (m, h, d)``.

    Methods mirror reference `src/codebook_update.jl:235-278`:
    ``fastbin``/``fast`` → direct ridge-regularized normal-equation
    solve (identical math; the histogram-vs-matmul distinction is moot
    on the MXU); ``naive`` → ridge-free least squares; ``lsqr``/``lsmr``
    → matrix-free CG on the normal equations."""
    G, F = codebook_stats(X, B, h, chunk=chunk)
    if method in ("fastbin", "fast"):
        return _solve_direct(G, F, h, rho)
    if method == "naive":
        # Dense backslash semantics (`:47-60`): minimum-norm LS, no ridge.
        mh, d = F.shape
        with jax.default_matmul_precision("highest"):
            C = jnp.linalg.lstsq(G, F)[0]
        return C.reshape(mh // h, h, d)
    if method in ("lsqr", "lsmr"):
        # G is singular without ridge (each codebook's one-hot columns
        # sum to the all-ones vector), so keep the same tiny ridge.
        return _solve_cg(G, F, h, rho=rho, maxiter=200)
    raise ValueError(f"unknown codebook update method {method!r}")


# ---------------------------------------------------------------------------
# Chain-restricted update (ChainQ)
# ---------------------------------------------------------------------------

def chain_dims(d: int, m: int) -> list[tuple[int, int]]:
    """Chain support structure: d dims split into m-1 balanced ranges;
    codebook i (0-based) spans ranges i-1 and i (reference
    ``get_cbdims_chain``, `src/codebook_update.jl:281-294`). Returns the
    (start, size) of each of the m-1 ranges."""
    return splitarray(d, m - 1)


@partial(jax.jit, static_argnames=("h", "d", "m", "rho"))
def _chain_solve(G: Array, F: Array, *, h: int, d: int, m: int,
                 rho: float) -> Array:
    """Per-range decoupled solves: dims in range i touch only codebooks
    i and i+1, so each range's normal equations are the (2h, 2h) block
    of G for that codebook pair (reference
    ``update_codebooks_chain_bin``, `src/codebook_update.jl:367-412`).
    All m-1 solves batch through one vmapped LU."""
    sub = chain_dims(d, m)
    ds_max = max(s for _, s in sub)
    # relative ridge + HIGHEST-precision LU: see `_solve_direct`
    scale = jnp.maximum(jnp.mean(jnp.diagonal(G)), 1.0)
    eye = (rho * scale) * jnp.eye(2 * h, dtype=jnp.float32)

    Gs = jnp.stack([G[i * h:(i + 2) * h, i * h:(i + 2) * h] + eye
                    for i in range(m - 1)])
    Fs = jnp.stack([
        jnp.pad(lax.dynamic_slice(F, (i * h, st), (2 * h, sz)),
                ((0, 0), (0, ds_max - sz)))
        for i, (st, sz) in enumerate(sub)])
    with jax.default_matmul_precision("highest"):
        sols = jnp.linalg.solve(Gs, Fs)                 # (m-1, 2h, ds_max)

    C = jnp.zeros((m, h, d), jnp.float32)
    for i, (st, sz) in enumerate(sub):
        C = lax.dynamic_update_slice(C, sols[None, i, :h, :sz], (i, 0, st))
        C = lax.dynamic_update_slice(C, sols[None, i, h:, :sz],
                                     (i + 1, 0, st))
    return C


def update_codebooks_chain(X: Array, B: Array, h: int = 256,
                           rho: float = 1e-4, chunk: int = 16384) -> Array:
    """Chain codebook update → full-dim ``C (m, h, d)`` with zero support
    outside each codebook's dim ranges. Reference
    `src/codebook_update.jl:353-412`."""
    d, m = X.shape[1], B.shape[1]
    G, F = codebook_stats(X, B, h, chunk=chunk)
    return _chain_solve(G, F, h=h, d=d, m=m, rho=rho)


# ---------------------------------------------------------------------------
# Generic structured update (arbitrary dimension supports)
# ---------------------------------------------------------------------------

def get_cbdims_chain(d: int, m: int):
    """Chain support structure as a ``(d, m)`` boolean map: the d dims
    split into m-1 balanced ranges; codebook i supports ranges i-1 and
    i. Reference ``get_cbdims_chain`` (`src/codebook_update.jl:280-294`,
    which returns per-codebook dim ranges — transposed here to the
    dim→codebooks map its caller builds at `:324-326`)."""
    import numpy as np

    dim2C = np.zeros((d, m), dtype=bool)
    for i, (st, sz) in enumerate(splitarray(d, m - 1)):
        dim2C[st:st + sz, i] = True
        dim2C[st:st + sz, i + 1] = True
    return dim2C


def update_codebooks_generic(X: Array, B: Array, h: int,
                             dim2C, rho: float = 1e-4,
                             chunk: int = 16384) -> Array:
    """Structured codebook update for arbitrary dimension supports →
    ``C (m, h, d)`` with zero support outside each codebook's dims.

    Reference ``update_codebooks_generic`` / ``updatecb_struct!``
    (`src/codebook_update.jl:296-350`) solves, for every dimension i, an
    LSQR restricted to the codebooks whose support covers i. TPU-first
    shape of the same math: build the (G, F) normal-equation statistics
    once on the MXU, then group dimensions by their *support signature*
    (the exact set of covering codebooks — for a chain there are only
    m-1 signatures for all d dims) and run ONE batched ridge solve per
    signature, with that group's dims as the right-hand-side columns.
    The per-dim iterative solves the reference farms to Distributed
    workers collapse into a handful of (k·h, k·h) dense solves.

    Args:
      dim2C: ``(d, m)`` boolean map (dimension i ← codebook j), or a
        callable ``f(d, m) -> (d, m) bool`` like `get_cbdims_chain`.
    """
    import numpy as np

    d, m = X.shape[1], B.shape[1]
    if callable(dim2C):
        dim2C = dim2C(d, m)
    dim2C = np.asarray(dim2C, dtype=bool)
    if dim2C.shape != (d, m):
        raise ValueError(f"dim2C shape {dim2C.shape} != (d={d}, m={m})")

    G, F = codebook_stats(X, B, h, chunk=chunk)

    # Group dims sharing a support signature (static structure → plain
    # Python; the solves below are the only device work).
    groups: dict[tuple[int, ...], list[int]] = {}
    for i in range(d):
        key = tuple(np.nonzero(dim2C[i])[0].tolist())
        if key:
            groups.setdefault(key, []).append(i)

    C = jnp.zeros((m, h, d), jnp.float32)
    scale = jnp.maximum(jnp.mean(jnp.diagonal(G)), 1.0)
    for cbs, dims in groups.items():
        cols = np.concatenate([np.arange(c * h, (c + 1) * h) for c in cbs])
        A = G[np.ix_(cols, cols)] + (rho * scale) * jnp.eye(
            len(cols), dtype=jnp.float32)
        with jax.default_matmul_precision("highest"):
            sol = jnp.linalg.solve(A, F[cols][:, np.asarray(dims)])
        for j, c in enumerate(cbs):
            C = C.at[c, :, np.asarray(dims)].set(sol[j * h:(j + 1) * h].T)
    return C
