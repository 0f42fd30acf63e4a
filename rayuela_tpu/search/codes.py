"""Code-resident ADC search — search packed uint8 codes, never a decoded
base.

This is the memory model that makes MCQ useful in deployment: the
index on the device is the **packed codes** (m bytes/vector + an
optional norms byte), like the reference's LUT scan over code arrays
(`deps/src/linscan_aqd.cpp:37-102`,
`deps/src/linscan_aqd_pairwise_byte.cpp:14-94`). A SIFT1M-class base
at m=8 is ~9 MB resident instead of a 256 MB bf16 decode.

* On the GPU, `search_codes` runs the fused scan kernel
  (`scan_kernel.scan_topk_codes`): each tile is decoded in-kernel and
  scored on the tensor cores; flagged queries are repaired by a deeper
  kernel pass and, failing that, the exact XLA LUT oracle.
* On the CPU it runs the XLA LUT oracle (`_xla_lut_scan_tiled`)
  directly; ``interpret=True`` runs the kernel in interpret mode
  instead (tests).

Scores follow the reference's LUT conventions: PQ/OPQ fold
``|c|^2 - 2 c.q_sub`` per subspace (true squared distances up to
+|q|^2, which the front-ends add); additive models fold ``-2 c.q`` plus
a quantized-norms table indexed by the extra byte
(`src/Linscan.jl:118-157`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from rayuela_tpu import platform
from rayuela_tpu.utils import cdiv, splitarray

Array = jax.Array

_HI = lax.Precision.HIGHEST


def pack_codes(B: Array, norms_codes: Array | None = None) -> Array:
    """Pack per-vector codes into int32 words, 4 codes per word
    (little-endian bytes) → ``(n, ceil(m'/4)) int32`` where m' counts
    the optional norms byte. Requires all codes < 256 (h <= 256, the
    reference's uint8 storage, `deps/src/types.h`)."""
    B = jnp.asarray(B)
    if norms_codes is not None:
        B = jnp.concatenate(
            [B, jnp.asarray(norms_codes).reshape(-1, 1).astype(B.dtype)],
            axis=1)
    n, mprime = B.shape
    nw = cdiv(mprime, 4)
    Bp = jnp.pad(B.astype(jnp.uint32), ((0, 0), (0, nw * 4 - mprime)))
    w = Bp.reshape(n, nw, 4)
    packed = (w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
              | (w[..., 3] << 24))
    return lax.bitcast_convert_type(packed, jnp.int32)


def unpack_codes(packed: Array, mprime: int) -> Array:
    """Inverse of `pack_codes` → ``(n, m') int32``."""
    u = lax.bitcast_convert_type(packed, jnp.uint32)
    cols = [(u[:, j // 4] >> (8 * (j % 4))) & 0xFF
            for j in range(mprime)]
    return jnp.stack(cols, axis=1).astype(jnp.int32)


def build_luts(C: Array, Q: Array, *, pq: bool = False,
               d: int | None = None,
               norms_cbook: Array | None = None) -> Array:
    """Per-query LUT stack ``T (m', h, nq) f32``.

    PQ/OPQ (``pq=True``): ``T[j,c,q] = |C_j[c]|^2 - 2 C_j[c].Q[q,sub_j]``
    (reference `src/Linscan.jl:5-26` table build). Additive
    (``pq=False``): ``T[j,c,q] = -2 C_j[c].Q[q]``; pass ``norms_cbook``
    (h',) to append the quantized-norms table the extra byte indexes
    (`src/Linscan.jl:118-157`). Either way scores exclude the +|q|^2
    constant (the front-end adds it). HIGHEST precision: this is the
    exact oracle the scan kernel is repaired and checked with."""
    m, h, ds = C.shape
    nq = Q.shape[0]
    if pq:
        d = Q.shape[1] if d is None else d
        tabs = []
        for j, (st, sz) in enumerate(splitarray(d, m)):
            Qs = Q[:, st:st + sz]
            if sz < ds:
                Qs = jnp.pad(Qs, ((0, 0), (0, ds - sz)))
            c2 = jnp.sum(C[j] * C[j], axis=-1, keepdims=True)   # (h, 1)
            tabs.append(c2 - 2.0 * jnp.matmul(
                C[j], Qs.T, preferred_element_type=jnp.float32,
                precision=_HI))
        T = jnp.stack(tabs)                                     # (m, h, nq)
    else:
        T = -2.0 * jnp.einsum("mhd,qd->mhq", C, Q,
                              preferred_element_type=jnp.float32,
                              precision=_HI)
    if norms_cbook is not None:
        if norms_cbook.size > h:
            raise ValueError(
                f"norms codebook ({norms_cbook.size} entries) must fit "
                f"the (h={h})-row table stack; train it with h' <= h "
                "(rayuela_tpu.search.norms.get_norms_codebook(h=...))")
        nt = jnp.broadcast_to(
            jnp.pad(norms_cbook.reshape(-1),
                    (0, h - norms_cbook.size))[:, None], (h, nq))
        T = jnp.concatenate([T, nt[None]], axis=0)
    return T


def xla_lut_scan(T: Array, B: Array, k: int,
                 lut_dtype=jnp.float32) -> tuple[Array, Array]:
    """Gather-based LUT scan in XLA — the exact reference
    implementation of the code-resident scores
    (`deps/src/linscan_aqd.cpp:37-102` accumulate, vectorized)."""
    mprime, h, nq = T.shape
    n = B.shape[0]
    Tc = T.astype(lut_dtype).astype(jnp.float32)
    flat = jnp.transpose(Tc, (2, 0, 1)).reshape(nq, mprime * h)
    idx = (B + jnp.arange(mprime, dtype=B.dtype)[None, :] * h)  # (n, m')
    s = jnp.sum(flat[:, idx], axis=2)                           # (nq, n)
    neg, ids = lax.top_k(-s, min(k, n))
    return -neg, ids.astype(jnp.int32)


class CodesIndex:
    """Scan-ready packed-code index: ~m bytes/vector resident.

    Build once (`build_codes_index`), search many times."""

    def __init__(self, packed: Array, mprime: int, C: Array, *,
                 pq: bool, d: int, norms_cbook: Array | None):
        self.packed, self.mprime, self.C = packed, mprime, C
        self.pq, self.d, self.norms_cbook = pq, d, norms_cbook
        self.n = packed.shape[0]
        self._ops: dict = {}

    def decode_operands(self, d: int, dtype) -> tuple[Array, Array]:
        """Cached kernel operands (`scan_kernel.decode_operands`): they
        depend only on (C, d, dtype), not on the queries."""
        from rayuela_tpu.search.scan_kernel import decode_operands
        key = (d, jnp.dtype(dtype).name)
        if key not in self._ops:
            self._ops[key] = decode_operands(
                self.C, pq=self.pq, d=d, norms_cbook=self.norms_cbook,
                dtype=dtype)
        return self._ops[key]


def build_codes_index(C: Array, B: Array, *, pq: bool = False,
                      d: int | None = None,
                      norms_cbook: Array | None = None,
                      norms_codes: Array | None = None) -> CodesIndex:
    if (norms_cbook is None) != (norms_codes is None):
        raise ValueError("norms_cbook and norms_codes go together")
    if not pq and norms_cbook is None:
        raise ValueError(
            "additive codebooks need a quantized-norms byte for the "
            "code-resident scan (reference src/Linscan.jl:118-157); "
            "train one via rayuela_tpu.search.norms or use the decoded "
            "index")
    B = jnp.asarray(B, jnp.int32)
    packed = pack_codes(B, norms_codes)
    mprime = B.shape[1] + (0 if norms_codes is None else 1)
    return CodesIndex(packed, mprime, jnp.asarray(C), pq=pq,
                      d=d if d is not None else -1,
                      norms_cbook=norms_cbook)


def _merge_topk(bs, bi, s, i, k):
    """Exact merge of two (nq, ·) top-k lists."""
    cs = jnp.concatenate([bs, s], axis=1)
    ci = jnp.concatenate([bi, i], axis=1)
    neg, loc = lax.top_k(-cs, min(k, cs.shape[1]))
    return -neg, jnp.take_along_axis(ci, loc, axis=1)


def _xla_lut_scan_tiled(index: "CodesIndex", Qj: Array, k: int, d: int,
                        lut_dtype, qblock: int = 128,
                        seg: int = 1 << 19) -> tuple[Array, Array]:
    """Exact XLA LUT oracle over the whole base, tiled over base
    segments x query blocks with an exact top-k merge, so the per-call
    (qblock, seg) score matrix and its (qblock, seg, m') gather
    intermediate stay ~2 GB instead of scaling with nq*n. The segment
    loop is outer, so each base segment is sliced and unpacked once.
    Scores exclude the +|q|^2 constant (callers add it)."""
    nq = Qj.shape[0]
    blocks = [(q0, min(q0 + qblock, nq))
              for q0 in range(0, nq, qblock)]
    Ts = [build_luts(index.C, Qj[a:b], pq=index.pq, d=d,
                     norms_cbook=index.norms_cbook) for a, b in blocks]
    bs: list = [None] * len(blocks)
    bi: list = [None] * len(blocks)
    for st in range(0, index.n, seg):
        stop = min(st + seg, index.n)
        Bseg = unpack_codes(index.packed[st:stop], index.mprime)
        for j in range(len(blocks)):
            s2, i2 = xla_lut_scan(Ts[j], Bseg, min(k, stop - st),
                                  lut_dtype=lut_dtype)
            i2 = i2 + st
            if bs[j] is None:
                bs[j], bi[j] = s2, i2
            else:
                bs[j], bi[j] = _merge_topk(bs[j], bi[j], s2, i2, k)
    return jnp.concatenate(bs, 0), jnp.concatenate(bi, 0)


def search_codes(index: CodesIndex, Q: Array, k: int, *,
                 interpret: bool = False, lut_dtype=jnp.float32,
                 **cfg) -> tuple[Array, Array]:
    """Exact top-k (for the kernel's scores) over a packed-code index.
    Returns true squared distances for the PQ / additive-with-norms
    conventions (adds the +|q|^2 constant).

    On the GPU (or with ``interpret=True``): the fused scan kernel,
    then `scan_kernel.repair_flagged` (a deeper kernel pass, then the
    tiled XLA LUT oracle) for the queries its certificate flags. On
    the CPU: the oracle alone. ``cfg`` overrides the kernel's plan
    (`scan_kernel.plan`)."""
    from rayuela_tpu.search.scan_kernel import (repair_flagged,
                                                scan_topk_codes)

    k = min(k, index.n)       # never return padded (inf, fake-id) rows
    d = Q.shape[1] if index.d in (-1, None) else index.d
    Qj = jnp.asarray(Q, jnp.float32)
    q2 = jnp.sum(Qj * Qj, axis=-1, keepdims=True)

    def oracle(Qs):
        return _xla_lut_scan_tiled(index, Qs, k, d, lut_dtype)

    if not (interpret or platform.on_gpu()):
        s, i = oracle(Qj)
        return s + q2, i
    dtype = jnp.float32 if interpret else platform.operand_dtype()
    Cf, nrm = index.decode_operands(d, dtype)
    m, h = index.C.shape[0], index.C.shape[1]

    def kernel(Qs, **over):
        return scan_topk_codes(Qs, index.packed, Cf, nrm, k, pq=index.pq,
                               m=m, h=h, interpret=interpret,
                               **{**cfg, **over})

    out = kernel(Qj)
    s, i = oracle(Qj) if out is None else repair_flagged(
        *out, Qj, kernel, oracle)
    return s + q2, i


def search_codes_streamed(C, B_packed, Q, k: int, *,
                          pq: bool = False, d: int | None = None,
                          norms_cbook=None, mprime: int | None = None,
                          shard_n: int = 100_000_000,
                          **kw) -> tuple[Array, Array]:
    """Code-resident search over a base too large for device memory:
    packed codes stay in HOST memory (a numpy array or an
    ``np.memmap`` over an on-disk code file) and stream to the device
    shard by shard; each shard runs `search_codes` on a shard-local
    `CodesIndex` and the per-shard top-k lists merge exactly on host.

    The beyond-device-memory rung of the memory-tiling ladder
    (reference ``nsplits``, `src/LSQ_GPU.jl:218-264`). The next
    shard's host->device transfer is issued before the current shard's
    scan (`jax.device_put` is asynchronous), so transfer overlaps
    compute; peak device memory is two shards.

    ``B_packed``: ``(n, ceil(m'/4)) int32`` in `pack_codes` layout
    (norms byte included for additive methods — pass ``mprime``)."""
    if not isinstance(B_packed, np.memmap):
        B_packed = np.asarray(B_packed)
    n, nw = B_packed.shape
    mp = nw * 4 if mprime is None else mprime
    Cj = jnp.asarray(C)
    Qj = jnp.asarray(Q)
    d = Qj.shape[1] if d is None else d
    nc = None if norms_cbook is None else jnp.asarray(norms_cbook)
    bounds = [(st, min(st + shard_n, n))
              for st in range(0, n, shard_n)]

    def put(j):
        a, b = bounds[j]
        return jax.device_put(np.ascontiguousarray(B_packed[a:b]))

    best_s = best_i = None
    pk_next = put(0)
    for j, (start, stop) in enumerate(bounds):
        pk = pk_next
        if j + 1 < len(bounds):
            pk_next = put(j + 1)           # async prefetch
        idx = CodesIndex(pk, mp, Cj, pq=pq, d=d, norms_cbook=nc)
        s, i = search_codes(idx, Qj, min(k, stop - start), **kw)
        s, i = np.asarray(s), np.asarray(i) + start
        del pk, idx
        if best_s is None:
            best_s, best_i = s, i
        else:
            cat_s = np.concatenate([best_s, s], axis=1)
            cat_i = np.concatenate([best_i, i], axis=1)
            order = np.argsort(cat_s, axis=1, kind="stable")[:, :k]
            best_s = np.take_along_axis(cat_s, order, axis=1)
            best_i = np.take_along_axis(cat_i, order, axis=1)
    return jnp.asarray(best_s), jnp.asarray(best_i)
