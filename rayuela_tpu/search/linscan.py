"""Asymmetric-distance (ADC) linear scan + recall evaluation.

Capability parity with reference `src/Linscan.jl` (``linscan_pq`` :5-26,
``linscan_opq`` :93-115, ``linscan_lsq`` :118-157, ``linscan_cq``
:160-193, ``eval_recall`` :196-234) and the native scan kernels it wraps
(`deps/src/linscan_aqd.cpp:37-102`,
`deps/src/linscan_aqd_pairwise_byte.cpp:14-176`).

No table lookups in the scan itself: the LUT scan is mathematically a
distance between the query and the *reconstruction*,

    sum_i LUT_i[B_i]  ==  |q|^2 - 2 q.x_hat + |x_hat|^2      (PQ/OPQ)
    -2 sum_i q.C_i[B_i] + dbnorm                             (LSQ byte-norms)
    sum_i |q - C_i[B_i]|^2                                   (CQ)

so the scan decodes each base tile once, scores it with one
(nq, d) x (d, tile) matmul, and keeps per-tile top-k (exact: the global
top-k is contained in the union of per-tile top-k). Identical scores
to the reference's LUT accumulation up to f32 summation order.

Two routes, chosen by `rayuela_tpu.platform`:

* GPU: the fused Pallas-Triton kernel (`scan_kernel`), which never
  writes a score block to device memory, plus an exact XLA repair of
  the queries its certificate flags;
* CPU: the XLA scans below (`scan_topk`, `exact_rescan`), which are
  also the kernel's exact oracles (f32, HIGHEST precision).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from rayuela_tpu import platform
from rayuela_tpu.ops.qerror import reconstruct, reconstruct_pq
from rayuela_tpu.utils import cdiv

Array = jax.Array

_HI = lax.Precision.HIGHEST


def _pad_axis0(x: Array, total: int, fill=0):
    pad = total - x.shape[0]
    if pad == 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg, constant_values=fill)


@partial(jax.jit, static_argnames=("k", "pq", "tile", "include_q2"))
def scan_topk(Q: Array, C: Array, B: Array, *, k: int,
              pq: bool = False, norm_term: Array | None = None,
              tile: int = 1 << 16, include_q2: bool = True
              ) -> tuple[Array, Array]:
    """Tiled decompress-and-gemm ADC scan with exact top-k.

    Args:
      Q: (nq, d) queries (already rotated for OPQ).
      C: (m, h, d) or (m, h, d//m) codebooks.
      B: (n, m) int32 codes.
      k: neighbors to return.
      pq: concatenative (True) vs additive (False) decode.
      norm_term: optional (n,) replacement for |x_hat|^2 (LSQ quantized
        dbnorms, reference `src/Linscan.jl:118-157`; or CQ's
        sum_i |c_i|^2). If None, the exact |x_hat|^2 is used.
      include_q2: add the per-query constant so returned values are true
        squared distances (ranking-irrelevant).

    Returns: (dists (nq, k) f32 ascending, ids (nq, k) int32).
    """
    nq = Q.shape[0]
    n = B.shape[0]
    k = min(k, n)  # never return padded (inf, fake-id) entries
    tile = min(tile, max(128, 1 << (n - 1).bit_length()))
    ntiles = cdiv(n, tile)
    npad = ntiles * tile

    Bp = _pad_axis0(B, npad).reshape(ntiles, tile, -1)
    nt = _pad_axis0(norm_term, npad).reshape(ntiles, tile) \
        if norm_term is not None else None
    starts = (jnp.arange(ntiles, dtype=jnp.int32) * tile)

    q2 = jnp.sum(Q * Q, axis=-1, keepdims=True) if include_q2 else 0.0
    kk = min(k, tile)

    def tile_fn(args):
        Bt, start, ntt = args
        Xh = reconstruct_pq(C, Bt, Q.shape[1]) if pq \
            else reconstruct(C, Bt)                               # (tile,d)
        qx = jnp.matmul(Q, Xh.T, preferred_element_type=jnp.float32,
                        precision=_HI)
        x2 = jnp.sum(Xh * Xh, axis=-1) if ntt is None else ntt
        scores = q2 - 2.0 * qx + x2[None, :]                      # (nq,tile)
        gidx = start + lax.broadcasted_iota(jnp.int32, (1, tile), 1)
        scores = jnp.where(gidx < n, scores, jnp.inf)
        neg, loc = lax.top_k(-scores, kk)
        return -neg, start + loc

    vals, ids = lax.map(tile_fn, (Bp, starts, nt))
    # (ntiles, nq, kk) → merge
    vals = jnp.transpose(vals, (1, 0, 2)).reshape(nq, ntiles * kk)
    ids = jnp.transpose(ids, (1, 0, 2)).reshape(nq, ntiles * kk)
    neg, loc = lax.top_k(-vals, min(k, ntiles * kk))
    return -neg, jnp.take_along_axis(ids, loc, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "tile"))
def exact_rescan(Q: Array, Xd: Array, x2: Array, k: int,
                 tile: int = 1 << 15) -> tuple[Array, Array]:
    """Exact XLA top-k over an already-decoded base (f32, HIGHEST
    precision): the repair for queries the scan kernel's certificate
    flags, and the CPU route of `search`."""
    n = Xd.shape[0]
    k = min(k, n)
    ntiles = cdiv(n, tile)
    npad = ntiles * tile
    Xp = _pad_axis0(Xd, npad).reshape(ntiles, tile, -1)
    x2p = _pad_axis0(x2, npad, fill=jnp.inf).reshape(ntiles, tile)
    q2 = jnp.sum(Q * Q, axis=-1, keepdims=True)
    starts = jnp.arange(ntiles, dtype=jnp.int32) * tile
    kk = min(k, tile)

    def tile_fn(args):
        Xt, x2t, start = args
        s = q2 - 2.0 * jnp.matmul(Q, Xt.T.astype(jnp.float32),
                                  preferred_element_type=jnp.float32,
                                  precision=_HI) \
            + x2t[None, :]
        neg, loc = lax.top_k(-s, kk)
        return -neg, start + loc

    vals, ids = lax.map(tile_fn, (Xp, x2p, starts))
    nq = Q.shape[0]
    vals = jnp.transpose(vals, (1, 0, 2)).reshape(nq, ntiles * kk)
    ids = jnp.transpose(ids, (1, 0, 2)).reshape(nq, ntiles * kk)
    neg, loc = lax.top_k(-vals, min(k, ntiles * kk))
    return -neg, jnp.take_along_axis(ids, loc, axis=1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Decoded index: decode once, search many times
# ---------------------------------------------------------------------------

class LinscanIndex:
    """A decoded, scan-ready base set: build once, search many times.

    The reference rebuilds per-query LUTs on every call; here the
    (n, d) decode + norm terms are the index (built once via
    `decode_base`), and each `search` is one fused scan."""

    def __init__(self, Xd: Array, x2: Array):
        self.Xd, self.x2 = Xd, x2
        self.n = Xd.shape[0]


def decode_base(C: Array, B: Array, *, pq: bool = False,
                d: int | None = None, norm_term: Array | None = None,
                dtype=jnp.float32, chunk: int = 65536
                ) -> tuple[Array, Array]:
    """One-time base decode → ``(Xd (n, d), x2 (n,))`` for the scan.

    ``norm_term`` overrides the exact |x_hat|^2 (LSQ quantized norms /
    CQ codebook norms, reference `src/Linscan.jl:118-193`)."""
    n = B.shape[0]
    nchunks = cdiv(n, chunk)
    pad = nchunks * chunk - n
    Bp = jnp.pad(B, ((0, pad), (0, 0)))

    def dec(Bc):
        Xc = reconstruct_pq(C, Bc, d) if pq else reconstruct(C, Bc)
        return Xc.astype(dtype), jnp.sum(Xc * Xc, axis=-1)

    Xd, x2 = lax.map(dec, Bp.reshape(nchunks, chunk, -1))
    Xd = Xd.reshape(nchunks * chunk, -1)[:n]
    x2 = x2.reshape(-1)[:n] if norm_term is None else norm_term
    return Xd, x2


def build_index(C: Array, B: Array, *, pq: bool = False,
                d: int | None = None, norm_term: Array | None = None,
                dtype=None) -> LinscanIndex:
    """``dtype=None`` takes `platform.operand_dtype()`: bf16 on the GPU
    (half the bytes each scan streams, tensor-core rate; scores keep
    f32 accumulation and the f32 ``x2``), f32 on the CPU (tests compare
    exactly)."""
    dtype = platform.operand_dtype() if dtype is None else dtype
    Xd, x2 = decode_base(C, B, pq=pq, d=d, norm_term=norm_term,
                         dtype=dtype)
    return LinscanIndex(Xd, x2)


def search(index: LinscanIndex, Q: Array, k: int, *,
           interpret: bool = False, **cfg) -> tuple[Array, Array]:
    """Exact top-k over a decoded index, as true squared distances.

    On the GPU (or with ``interpret=True``): the fused scan kernel,
    then `scan_kernel.repair_flagged` (a deeper kernel pass, then
    `exact_rescan`) for the queries its certificate flags. On the CPU:
    `exact_rescan` alone. ``cfg`` overrides the kernel's plan
    (`scan_kernel.plan`)."""
    from rayuela_tpu.search.scan_kernel import (repair_flagged,
                                                scan_topk_decoded)

    k = min(k, index.n)       # never return padded (inf, fake-id) rows
    Q = jnp.asarray(Q, jnp.float32)
    if not (interpret or platform.on_gpu()):
        return exact_rescan(Q, index.Xd, index.x2, k)

    def kernel(Qs, **over):
        return scan_topk_decoded(Qs, index.Xd, index.x2, k,
                                 interpret=interpret, **{**cfg, **over})

    def oracle(Qs):
        d2, i2 = exact_rescan(Qs, index.Xd, index.x2, k)
        return d2 - jnp.sum(Qs * Qs, axis=-1, keepdims=True), i2

    out = kernel(Q)
    if out is None:
        return exact_rescan(Q, index.Xd, index.x2, k)
    s, i = repair_flagged(*out, Q, kernel, oracle)
    return s + jnp.sum(Q * Q, axis=-1, keepdims=True), i


def search_streamed(C: Array, B, Q: Array, k: int, *,
                    pq: bool = False, d: int | None = None,
                    norm_term=None, shard_size: int = 1 << 20,
                    interpret: bool = False) -> tuple[Array, Array]:
    """Search a base set too large to decode into device memory at
    once: codes stream from host memory shard by shard (each shard is
    decoded, scanned, and released), and the per-shard top-k lists
    merge exactly on host (reference ``nsplits``,
    `src/LSQ_GPU.jl:218-264`, applied to the query path)."""
    n = B.shape[0]
    d = Q.shape[1] if d is None else d
    best_v = best_i = None
    for start in range(0, n, shard_size):
        stop = min(start + shard_size, n)
        Bs = jnp.asarray(B[start:stop])
        nt = None if norm_term is None else jnp.asarray(
            norm_term[start:stop])
        idx = build_index(C, Bs, pq=pq, d=d, norm_term=nt)
        dv, di = search(idx, Q, min(k, stop - start), interpret=interpret)
        dv, di = np.asarray(dv), np.asarray(di) + start
        if best_v is None:
            best_v, best_i = dv, di
        else:
            cat_v = np.concatenate([best_v, dv], axis=1)
            cat_i = np.concatenate([best_i, di], axis=1)
            order = np.argsort(cat_v, axis=1)[:, :k]
            best_v = np.take_along_axis(cat_v, order, axis=1)
            best_i = np.take_along_axis(cat_i, order, axis=1)
    return jnp.asarray(best_v), jnp.asarray(best_i)


def _route(Q: Array, C: Array, B: Array, *, k: int, pq: bool,
           norm_term: Array | None = None, **kw) -> tuple[Array, Array]:
    """Decoded-index search (kernel + exact repair) on the GPU, the
    tiled XLA scan on the CPU."""
    if platform.on_gpu():
        idx = build_index(C, B, pq=pq, d=Q.shape[1], norm_term=norm_term)
        return search(idx, Q, min(k, B.shape[0]))
    return scan_topk(Q, C, B, k=k, pq=pq, norm_term=norm_term, **kw)


# ---------------------------------------------------------------------------
# Reference-parity front-ends (names mirror src/Linscan.jl)
# ---------------------------------------------------------------------------

def linscan_pq(C: Array, Q: Array, B: Array, k: int = 1000,
               **kw) -> tuple[Array, Array]:
    """PQ ADC scan. Reference `src/Linscan.jl:5-26` →
    `deps/src/linscan_aqd.cpp`."""
    return _route(Q, C, B, k=k, pq=True, **kw)


def linscan_opq(C: Array, Q: Array, B: Array, R: Array, k: int = 1000,
                **kw) -> tuple[Array, Array]:
    """OPQ scan: rotate queries, then PQ scan. Reference
    `src/Linscan.jl:93-115`."""
    Qr = jnp.matmul(Q, R, preferred_element_type=jnp.float32)
    return _route(Qr, C, B, k=k, pq=True, **kw)


def linscan_lsq(C: Array, Q: Array, B: Array, norms_cbook: Array,
                norms_codes: Array, R: Array | None = None,
                k: int = 1000, **kw) -> tuple[Array, Array]:
    """Full-dim additive scan with a quantized-norms byte.

    Reference `src/Linscan.jl:118-157` →
    `deps/src/linscan_aqd_pairwise_byte.cpp:14-94`: dot-product LUTs
    plus a separate dbnorms table indexed by the extra code byte.
    """
    Qr = Q if R is None else jnp.matmul(Q, R,
                                        preferred_element_type=jnp.float32)
    dbnorms = jnp.take(norms_cbook.reshape(-1), norms_codes.reshape(-1))
    return _route(Qr, C, B, k=k, pq=False, norm_term=dbnorms, **kw)


def linscan_cq(C: Array, Q: Array, B: Array, k: int = 1000,
               **kw) -> tuple[Array, Array]:
    """CQ-style scan: sum over codebooks of |q - c_i|^2 (no norms byte).

    Reference `src/Linscan.jl:160-193` →
    `linscan_aqd_pairwise_byte.cpp:97-176`. Differs from true distance by
    per-codebook norms: norm_term = sum_i |C_i[B_i]|^2 and the q2
    constant appears m times."""
    m = C.shape[0]
    c2 = jnp.sum(C * C, axis=-1)                       # (m, h)
    codenorms = jnp.sum(
        jnp.take_along_axis(c2, B.T, axis=1), axis=0)  # (n,)
    d, i = _route(Q, C, B, k=k, pq=False, norm_term=codenorms, **kw)
    # _route's scores include one |q|^2; CQ's convention has m of them
    q2 = jnp.sum(Q * Q, axis=-1, keepdims=True)
    return d + (m - 1) * q2, i


# ---------------------------------------------------------------------------
# Recall evaluation
# ---------------------------------------------------------------------------

def eval_recall(ids: Array, gt: Array, *, ks=(1, 2, 5, 10, 20, 50, 100,
                                              200, 500, 1000, 2000,
                                              5000, 10000),
                verbose: bool = True) -> np.ndarray:
    """Recall@N curve: fraction of queries whose true NN appears in the
    top-N returned ids, for N = 1..k.

    Reference `src/Linscan.jl:196-234` (prints r@{1,2,5,...}, returns the
    full curve)."""
    ids = jnp.asarray(ids)
    gt = jnp.asarray(gt).reshape(-1)
    hits = (ids == gt[:, None]).astype(jnp.float32)
    curve = np.asarray(jnp.mean(lax.cummax(hits, axis=1), axis=0))
    if verbose:
        for N in ks:
            if N <= curve.shape[0]:
                print(f"recall@{N} = {curve[N - 1]:.4f}")
    return curve
