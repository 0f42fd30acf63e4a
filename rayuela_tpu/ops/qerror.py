"""Reconstruction and quantization-error ops.

Equivalents of reference `src/qerrors.jl` (``reconstruct`` :6-33,
``veccost`` :36-66, ``qerror`` :69-74, ``qerror_pq/_opq`` :77-100) and of
the MRF-term helpers in `src/utils.jl` (``get_unaries`` :121-149,
``get_binaries`` :152-171):

* decoding a code is a row-gather from each codebook
  (`rayuela_tpu.utils.gather_rows`), exact at any precision;
* per-vector cost is a fused elementwise-square + row reduction, also
  free of matmuls, so `qerror` is an exact f32 sum on every platform.

Data model: ``C (m, h, d)`` full-dimensional codebooks (additive:
``x_hat = sum_i C[i, B[:, i]]``) or ``C (m, h, d//m)`` per-subspace
codebooks (concatenative), ``B (n, m)`` int32 0-based codes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu.utils import cdiv, gather_rows

Array = jax.Array


def reconstruct(C: Array, B: Array) -> Array:
    """Additive decode: ``x_hat[v] = sum_i C[i, B[v, i]]`` → (n, d).

    Full-dimensional methods (RVQ/ERVQ/ChainQ/LSQ/SR). Reference
    `src/qerrors.jl:6-25`.
    """
    C, B = jnp.asarray(C), jnp.asarray(B)
    m = C.shape[0]

    def body(i, acc):
        return acc + gather_rows(C[i], B[:, i])

    n, d = B.shape[0], C.shape[2]
    return lax.fori_loop(0, m, body, jnp.zeros((n, d), C.dtype))


def reconstruct_pq(C: Array, B: Array, d: int | None = None) -> Array:
    """Concatenative decode for per-subspace codebooks ``C (m, h, ds)``
    → (n, d). Reference `src/qerrors.jl:26-33` (cell-array path).

    With ``d`` given and d % m != 0, subspaces are the balanced uneven
    ranges of ``splitarray`` and each codebook's trailing zero-padding
    is dropped (see `models.pq._split_subspaces`)."""
    sub = jax.vmap(gather_rows, in_axes=(0, 1))(C, B)   # (m, n, ds)
    n = B.shape[0]
    m, _, ds = C.shape
    if d is None or d == m * ds:
        return jnp.transpose(sub, (1, 0, 2)).reshape(n, -1)
    from rayuela_tpu.utils import splitarray
    parts = [sub[i][:, :sz] for i, (_, sz) in enumerate(splitarray(d, m))]
    return jnp.concatenate(parts, axis=1)


def veccost(X: Array, C: Array, B: Array, *, pq: bool = False) -> Array:
    """Per-vector squared reconstruction error (n,).

    Reference `src/qerrors.jl:36-66` (devectorized SIMD loop there; a
    gather + fused reduction here)."""
    Xr = reconstruct_pq(C, B, X.shape[1]) if pq else reconstruct(C, B)
    e = X - Xr
    return jnp.sum(e * e, axis=-1)


def veccost_chunked(X: Array, C: Array, B: Array,
                    chunk: int = 16384) -> Array:
    """`veccost` with the n axis streamed in fixed chunks, so the
    decode transient stays bounded for base-set-sized n (the role of
    the reference GPU's ``nsplits``, `src/LSQ_GPU.jl:218-264`)."""
    n, d = X.shape
    m = B.shape[1]
    nchunks = cdiv(n, chunk)
    pad = nchunks * chunk - n
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    Bp = jnp.pad(B, ((0, pad), (0, 0)))
    out = lax.map(lambda ab: veccost(ab[0], C, ab[1]),
                  (Xp.reshape(nchunks, chunk, d),
                   Bp.reshape(nchunks, chunk, m)))
    return out.reshape(-1)[:n]


def qerror(X: Array, C: Array, B: Array, *, pq: bool = False) -> Array:
    """Mean squared reconstruction error — the training objective
    everywhere in the reference (`src/qerrors.jl:69-74`)."""
    return jnp.mean(veccost(X, C, B, pq=pq))


def qerror_pq(X: Array, C: Array, B: Array) -> Array:
    """PQ objective (concatenative decode). Reference `src/qerrors.jl:93-100`."""
    return qerror(X, C, B, pq=True)


def qerror_opq(X: Array, C: Array, B: Array, R: Array) -> Array:
    """OPQ objective: error of the rotated data against the PQ decode.
    Reference `src/qerrors.jl:77-90` (there: ``R*decode`` vs data; same
    number since R is orthonormal)."""
    return qerror(jnp.matmul(X, R, preferred_element_type=jnp.float32),
                  C, B, pq=True)


def get_unaries(X: Array, C: Array) -> Array:
    """MRF unary terms ``(n, m, h)``: ``|c|^2 - 2 c.x`` per codebook entry.

    Reference `src/utils.jl:121-149`. Used by the parity tests and the
    LUT-scan reference implementation; the production ICM encoder keeps
    residuals instead (see `rayuela_tpu.ops.icm`)."""
    c2 = jnp.sum(C * C, axis=-1)                            # (m, h)
    xc = jnp.einsum("nd,mhd->nmh", X, C,
                    preferred_element_type=jnp.float32)
    return c2[None] - 2.0 * xc


def get_binaries(C: Array) -> Array:
    """All-pairs MRF binary terms ``(m, m, h, h)`` with
    ``binaries[i, j] = 2 * C_i @ C_j^T`` (diagonal unused).

    Reference `src/utils.jl:152-171` materializes only the upper
    triangle; here the full (m, m, h, h) tensor is one einsum and at
    m=16, h=256 is 64 MB — fine in device memory."""
    return 2.0 * jnp.einsum("ihd,jgd->ijhg", C, C,
                            preferred_element_type=jnp.float32)
