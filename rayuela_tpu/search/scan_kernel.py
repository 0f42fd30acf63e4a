"""Fused ADC scan + candidate selection — one Pallas-Triton kernel.

Plain XLA scores a (queries x rows) block with a matmul, writes the
f32 block to device memory and reads it back for `lax.top_k`
(`linscan.exact_rescan`): at the SIFT1M shape (1e4 queries x 1e6
rows) that is ~40 GB each way, while the packed codes are 8 MB. This
kernel reduces every score tile to per-query candidates before
anything leaves the SM, for both index types:

* **decoded** — the operand tile is loaded from an ``(n, d)`` decoded
  base (bf16 on the GPU) plus its per-row norm term ``x2``;
* **codes** — the operand tile is decoded in-kernel from the packed
  uint8 codes (`codes.pack_codes` layout) by gathers from the
  flattened codebooks ``Cf (m*h, d)`` (block-diagonal for PQ/OPQ;
  64 KB in bf16 at m=8, h=256, d=128, so it stays cache-resident),
  and ``x2`` by gathers from a per-entry norms table.

Grid ``(query blocks, base splits)``, query blocks fastest, so the
programs resident at one time stream the same base rows through L2.
Program ``(qb, s)`` holds ``bq`` queries and walks split ``s`` ``tn``
rows at a time:

1. build the ``(tn, d)`` operand tile, 128 columns at a time;
2. score it on the tensor cores, ``x2 - 2 q.x`` (`pl.dot`, f32
   accumulation; the -2 is folded into the query operand, exactly);
3. insert the ``(bq, tn)`` scores into a per-(query, lane) sorted
   buffer of depth ``r`` (lane = column of the tile), and keep per
   query the minimum of every score the buffers dropped.

The Triton route has min/argmin and loops but no sort, so selection
is "best ``r`` per lane plus a bound on what was dropped". The kernel
emits ``r * tn`` candidates per (query, split) and the dropped
minimum; an XLA `top_k` over the candidates gives the k best, and a
query is **flagged** iff its dropped minimum is below its k-th
candidate — the only case in which a row outside the candidates could
belong to its top k. Callers repair flagged queries with the exact
XLA oracles, so results are exact for the kernel's scores, always.

Row ids are int32, so one call covers up to 2**31 rows: no
segmentation below that.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rayuela_tpu.utils import cdiv, splitarray

Array = jax.Array

# expected flagged queries per query the depth/lane plan allows (a
# flagged query costs one exact XLA rescan of the whole base)
_FLAG_BUDGET = 1e-4
# per-program register budget for the running buffers: r * bq * tn
# values plus as many ids, over num_warps * 32 threads
_REGS_PER_THREAD = 128
# enough programs to keep every SM of the card busy several times over
_MIN_PROGRAMS = 1024
# plan overrides of the repair pass: the deepest buffers, 16 per lane
_RESCUE = dict(r=16, tn=16)
# contraction chunk of the score matmul: the query operand of a chunk
# stays in registers, wider descriptors loop over chunks
_DC = 128


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _poisson_sf(r: int, lam: float) -> float:
    """P(X > r) for X ~ Poisson(lam)."""
    term, cdf = math.exp(-lam), 0.0
    for j in range(r + 1):
        cdf += term
        term *= lam / (j + 1)
    return max(0.0, 1.0 - cdf)


def plan(nq: int, n: int, k: int, *, bq: int | None = None,
         tn: int | None = None, r: int | None = None,
         nsplit: int | None = None, num_warps: int | None = None,
         num_stages: int = 2) -> dict | None:
    """Kernel configuration for one call, or None when the kernel
    cannot hold k candidates per query (callers then use XLA).

    ``r`` (buffer depth) follows k; the lane count ``nsplit * tn`` is
    the smallest (at or above the occupancy floor) for which a query's
    true top k — spread over lanes like Poisson(k / lanes) per lane —
    overflows some lane's buffer with probability under
    ``_FLAG_BUDGET``. Any argument given overrides the plan."""
    if k > n:
        return None
    r = r or (4 if k <= 128 else 8 if k <= 1024 else 16)
    # measured on the card: 32-wide tiles with bq=64 keep the buffers at
    # 128 registers a thread (4 warps at r=4, 8 at r=8)
    tn = tn or (32 if r <= 8 else 16)
    bq = bq or min(64, max(16, _next_pow2(nq)))
    nqb = cdiv(nq, bq)
    max_split = cdiv(n, tn)
    if nsplit is None:
        nsplit = min(max_split, max(1, cdiv(_MIN_PROGRAMS, nqb)))
        while (nsplit < max_split and nsplit * tn * _poisson_sf(
                r, k / (nsplit * tn)) > _FLAG_BUDGET):
            nsplit = min(max_split, nsplit * 2)
    nsplit = min(nsplit, max_split)
    nt = cdiv(n, nsplit * tn)
    nsplit = cdiv(n, nt * tn)             # no split left empty
    if nsplit * tn * r < k:
        return None
    if num_warps is None:
        words = 2 * r * bq * tn
        num_warps = min(16, max(4, _next_pow2(
            cdiv(words, 32 * _REGS_PER_THREAD))))
    return dict(bq=bq, tn=tn, r=r, nsplit=nsplit, nt=nt,
                num_warps=num_warps, num_stages=num_stages)


def _insert(vals, ids, drop, s, sid):
    """Insert the (bq, tn) scores ``s`` (row ids ``sid``) into the
    per-lane sorted buffers; what falls off the end lowers ``drop``."""
    vals, ids = list(vals), list(ids)
    v, vi = s, sid
    for j in range(len(vals)):
        lt = v < vals[j]
        nv, ni = jnp.where(lt, v, vals[j]), jnp.where(lt, vi, ids[j])
        v, vi = jnp.where(lt, vals[j], v), jnp.where(lt, ids[j], vi)
        vals[j], ids[j] = nv, ni
    return tuple(vals), tuple(ids), jnp.minimum(drop, v)


def _owner(col: Array, d: int, m: int) -> Array:
    """Subspace owning each column under `splitarray(d, m)`: the first
    ``d % m`` subspaces are one column wider."""
    base, rem = divmod(d, m)
    wide = rem * (base + 1)
    return jnp.where(col < wide, col // (base + 1),
                     rem + (col - wide) // max(base, 1))


def _byte(w: Array, j) -> Array:
    """Code byte ``j`` of packed int32 words ``w`` (4 per word)."""
    return lax.shift_right_logical(w, 8 * (j % 4)) & 0xFF


def _codes_x(pk_ref, cf_ref, rows, valid, col, *, pq: bool, d: int,
             m: int, h: int):
    """Decode one ``(tn, len(col))`` column chunk of the operand tile
    from the packed codes by gathers from ``Cf``."""
    cmask = valid[:, None] & (col < d)[None, :]
    if pq:
        own = _owner(col, d, m)
        w = plgpu.load(pk_ref.at[rows[:, None], (own // 4)[None, :]],
                       mask=cmask, other=0)
        b = lax.shift_right_logical(w, (8 * (own % 4))[None, :]) & 0xFF
        return plgpu.load(cf_ref.at[own[None, :] * h + b, col[None, :]],
                          mask=cmask, other=0)
    acc = None
    for j in range(m):
        bj = _byte(plgpu.load(pk_ref.at[rows, j // 4], mask=valid,
                              other=0), j)
        xj = plgpu.load(cf_ref.at[(j * h + bj)[:, None], col[None, :]],
                        mask=cmask, other=0).astype(jnp.float32)
        acc = xj if acc is None else acc + xj
    return acc.astype(cf_ref.dtype)


def _codes_x2(pk_ref, nrm_ref, rows, valid, *, m: int, h: int,
              has_norms: bool):
    """Per-row norm term from the codes: the quantized-norms byte's
    value (additive) or the sum of per-entry norms (PQ, exact)."""
    if has_norms:
        bn = _byte(plgpu.load(pk_ref.at[rows, m // 4], mask=valid,
                              other=0), m)
        return plgpu.load(nrm_ref.at[m * h + bn], mask=valid, other=0.0)
    x2 = None
    for j in range(m):
        bj = _byte(plgpu.load(pk_ref.at[rows, j // 4], mask=valid,
                              other=0), j)
        e = plgpu.load(nrm_ref.at[j * h + bj], mask=valid, other=0.0)
        x2 = e if x2 is None else x2 + e
    return x2


def _kernel(q_ref, *refs, kind: str, n: int, d: int, tn: int, nt: int,
            r: int, pq: bool = False, m: int = 0, h: int = 0,
            has_norms: bool = False):
    *src, ov_ref, oi_ref, od_ref = refs
    bq, width = q_ref.shape
    base = pl.program_id(1) * (nt * tn)
    lane = lax.broadcasted_iota(jnp.int32, (tn,), 0)
    # the contraction runs in chunks of at most _DC columns: one chunk's
    # query operand is loaded once, outside the row loop; wider
    # operands loop over chunks (rolled, so shared memory holds one)
    w = min(_DC, width)
    nchunk = width // w
    q1 = q_ref[...] if nchunk == 1 else None

    def chunk(rows, valid, t, c0, q):
        col = c0 + lax.broadcasted_iota(jnp.int32, (w,), 0)
        if kind == "decoded":
            # the last chunk may overhang d: its columns are masked
            x = plgpu.load(src[0].at[pl.ds(base + t * tn, tn),
                                     pl.ds(c0, w)],
                           mask=valid[:, None] & (col < d)[None, :],
                           other=0)
        else:
            x = _codes_x(src[0], src[1], rows, valid, col, pq=pq, d=d,
                         m=m, h=h)
        return pl.dot(q, x.astype(q.dtype), trans_b=True)

    def step(t, carry):
        vals, ids, drop = carry
        rows = base + t * tn + lane
        valid = rows < n
        if q1 is not None:
            s = chunk(rows, valid, t, 0, q1)
        else:
            s = lax.fori_loop(
                0, nchunk,
                lambda c, acc: acc + chunk(
                    rows, valid, t, c * w,
                    q_ref[:, pl.ds(pl.multiple_of(c * w, w), w)]),
                jnp.zeros((bq, tn), jnp.float32))
        if kind == "decoded":
            x2 = plgpu.load(src[1].at[pl.ds(base + t * tn, tn)],
                            mask=valid, other=0.0)
        else:
            x2 = _codes_x2(src[0], src[2], rows, valid, m=m, h=h,
                           has_norms=has_norms)
        s = s + x2[None, :]
        s = jnp.where(valid[None, :], s, jnp.inf)
        sid = jnp.broadcast_to(rows[None, :], (bq, tn))
        return _insert(vals, ids, drop, s, sid)

    inf = jnp.full((bq, tn), jnp.inf, jnp.float32)
    init = ((inf,) * r, (jnp.full((bq, tn), -1, jnp.int32),) * r, inf)
    vals, ids, drop = lax.fori_loop(0, nt, step, init)
    for j in range(r):
        ov_ref[:, j * tn:(j + 1) * tn] = vals[j]
        oi_ref[:, j * tn:(j + 1) * tn] = ids[j]
    od_ref[...] = jnp.min(drop, axis=1)[None, :]


@functools.partial(jax.jit, static_argnames=(
    "kind", "n", "d", "k", "pq", "m", "h", "has_norms", "bq", "tn", "r",
    "nsplit", "nt", "num_warps", "num_stages", "interpret"))
def _topk(qop, *src, kind: str, n: int, d: int, k: int, pq: bool = False,
          m: int = 0, h: int = 0, has_norms: bool = False, bq: int,
          tn: int, r: int, nsplit: int, nt: int, num_warps: int,
          num_stages: int, interpret: bool = False):
    """``qop``: the per-query operand, ``-2 Q`` padded to a
    power-of-two width (`_query_operand`)."""
    nq, width = qop.shape
    nqp = cdiv(nq, bq) * bq
    qop = jnp.pad(qop, ((0, nqp - nq), (0, 0)))
    full = [pl.BlockSpec(a.shape, lambda qb, s, nd=a.ndim: (0,) * nd)
            for a in src]
    kern = functools.partial(_kernel, kind=kind, n=n, d=d, tn=tn, nt=nt,
                             r=r, pq=pq, m=m, h=h, has_norms=has_norms)
    ncand = r * tn
    vals, ids, drop = pl.pallas_call(
        kern,
        grid=(nqp // bq, nsplit),
        in_specs=[pl.BlockSpec((bq, width), lambda qb, s: (qb, 0))] + full,
        out_specs=[pl.BlockSpec((bq, ncand), lambda qb, s: (qb, s)),
                   pl.BlockSpec((bq, ncand), lambda qb, s: (qb, s)),
                   pl.BlockSpec((1, bq), lambda qb, s: (s, qb))],
        out_shape=[jax.ShapeDtypeStruct((nqp, nsplit * ncand), jnp.float32),
                   jax.ShapeDtypeStruct((nqp, nsplit * ncand), jnp.int32),
                   jax.ShapeDtypeStruct((nsplit, nqp), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name=f"rayuela_scan_{kind}",
    )(qop, *src)
    neg, loc = lax.top_k(-vals[:nq], k)
    best = -neg
    flagged = jnp.min(drop[:, :nq], axis=0) < best[:, k - 1]
    return best, jnp.take_along_axis(ids[:nq], loc, axis=1), flagged


def _query_operand(Q: Array, d: int, dtype) -> Array:
    """``-2 Q`` at the operand dtype (the scaling is exact), zero-padded
    to a power-of-two width of at least 16 (Triton's smallest dot)."""
    dp = _next_pow2(max(16, d))
    return jnp.pad(-2.0 * Q[:, :d], ((0, 0), (0, dp - d))).astype(dtype)


def scan_topk_decoded(Q: Array, Xd: Array, x2: Array, k: int, *,
                      interpret: bool = False, **cfg):
    """Top-k of ``x2 - 2 Q.Xd`` (no ``|q|^2``) over a decoded base.
    Returns ``(scores, ids, flagged)``, or None when `plan` declines
    (k too large for the candidate buffers)."""
    n, d = Xd.shape
    p = plan(Q.shape[0], n, k, **cfg)
    if p is None:
        return None
    return _topk(_query_operand(Q, d, Xd.dtype), Xd, x2, kind="decoded",
                 n=n, d=d, k=k, interpret=interpret, **p)


def decode_operands(C: Array, *, pq: bool, d: int,
                    norms_cbook: Array | None = None,
                    dtype=jnp.bfloat16) -> tuple[Array, Array]:
    """Kernel operands for a code-resident index: ``Cf (m*h, d)`` at
    ``dtype`` (block-diagonal subspace placement for PQ/OPQ) and the
    f32 norms table ``nrm ((m+1)*h,)``: PQ holds ``|C_j[c]|^2`` per
    entry (so ``x2`` is the exact ``|x_hat|^2``), additive methods
    hold the quantized-norms codebook in the extra byte's slot."""
    m, h, ds = C.shape
    C = jnp.asarray(C, jnp.float32)
    if pq:
        Cf = jnp.zeros((m * h, d), jnp.float32)
        nrm = jnp.zeros(((m + 1) * h,), jnp.float32)
        for j, (st, sz) in enumerate(splitarray(d, m)):
            Cj = C[j][:, :sz]          # uneven split: drop the padding
            Cf = Cf.at[j * h:(j + 1) * h, st:st + sz].set(Cj)
            nrm = nrm.at[j * h:(j + 1) * h].set(jnp.sum(Cj * Cj, axis=-1))
    else:
        Cf = C.reshape(m * h, ds)
        nc = jnp.zeros((h,), jnp.float32)
        if norms_cbook is not None:
            nc = nc.at[:norms_cbook.size].set(
                jnp.asarray(norms_cbook, jnp.float32).reshape(-1))
        nrm = jnp.concatenate([jnp.zeros((m * h,), jnp.float32), nc])
    return Cf.astype(dtype), nrm


def scan_topk_codes(Q: Array, packed: Array, Cf: Array, nrm: Array,
                    k: int, *, pq: bool, m: int, h: int,
                    interpret: bool = False, **cfg):
    """Top-k over a packed-code index (no ``|q|^2``): PQ/OPQ scores
    ``|x_hat|^2 - 2 q.x_hat``, additive ones ``norm_byte - 2 q.x_hat``
    — the reference's LUT conventions (`src/Linscan.jl:5-26,118-157`).
    Returns ``(scores, ids, flagged)`` or None (see `plan`)."""
    n, d = packed.shape[0], Cf.shape[1]
    p = plan(Q.shape[0], n, k, **cfg)
    if p is None:
        return None
    return _topk(_query_operand(Q, d, Cf.dtype), packed, Cf, nrm,
                 kind="codes", n=n, d=d, k=k, pq=pq, m=m, h=h,
                 has_norms=not pq, interpret=interpret, **p)


def repair_flagged(s: Array, i: Array, fl, Q: Array, kernel, oracle):
    """Exact repair of the queries the certificate flagged.

    First ``kernel(Q_flagged, **_RESCUE)`` — the same scan with 16-deep
    buffers, for which an overflow is vanishingly rare — then, for any
    query still flagged (or when the plan declines), ``oracle`` (an
    exact XLA scan). The flagged set is padded to a power of two to
    bound recompiles. ``kernel`` returns ``(scores, ids, flagged)`` or
    None, ``oracle`` ``(scores, ids)``, all in the caller's score
    convention."""
    fl = np.asarray(fl)
    qidx = np.nonzero(fl)[0]
    if qidx.size == 0:
        return s, i
    nf = _next_pow2(qidx.size)
    out = kernel(Q[np.pad(qidx, (0, nf - qidx.size), mode="edge")],
                 **_RESCUE)
    if out is not None:
        s2, i2, f2 = (a[:qidx.size] for a in out)
        s, i = s.at[qidx].set(s2), i.at[qidx].set(i2)
        qidx = qidx[np.asarray(f2)]
    if qidx.size:
        s2, i2 = oracle(Q[qidx])
        s, i = s.at[qidx].set(s2), i.at[qidx].set(i2)
    return s, i

