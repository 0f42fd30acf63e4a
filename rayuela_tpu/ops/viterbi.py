"""Batched Viterbi (min-sum) encoding for chain-structured MCQ.

Equivalent of the reference's three ChainQ encoding backends — the
per-vector Julia forward/backtrace (`src/ChainQ.jl:36-200`), the C++
OpenMP `viterbi_encoding` (`deps/src/encode_icm.cpp:63-152`), and the
CUDA `viterbi_forward` kernel (`deps/src/cudautils.cu:198-291`) — as ONE
batched formulation:

* unaries ``|c|^2 - 2 c.x`` for all (vector, stage, label) come from a
  single (n, d) x (d, m*h) matmul;
* the forward pass is a `lax.scan` over the m-1 chain edges whose body
  is a broadcasted (chunk, h, h) min-plus reduction, which XLA fuses
  into one reduction — all n vectors advance one stage per step,
  instead of one vector at a time;
* the backtrace is a reverse `lax.scan` of per-vector argmin-table
  gathers.

Vectors are processed in fixed-size chunks so the (chunk, h, h)
min-plus tensor and the (m-1, chunk, h) argmin tables stay bounded
(h=256: chunk=2048 → 512 MB transient, 60 MB tables) — the same memory
tiling role as the reference's `nsplits` (`src/LSQ_GPU.jl:218-264`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu.utils import cdiv

Array = jax.Array


def chain_binaries(C: Array) -> Array:
    """Adjacent-pair MRF terms ``(m-1, h, h)``: ``2 C_i C_{i+1}^T``.

    Reference `src/ChainQ.jl:316-319` (only adjacent pairs exist in the
    chain). HIGHEST precision: Viterbi is exact on these terms, so a
    TF32 pass would change which codes win."""
    return 2.0 * jnp.einsum("ihd,igd->ihg", C[:-1], C[1:],
                            preferred_element_type=jnp.float32,
                            precision=lax.Precision.HIGHEST)


def chain_unaries(X: Array, C: Array) -> Array:
    """Unary terms ``(m, n, h)``: ``|c|^2 - 2 c.x``."""
    c2 = jnp.sum(C * C, axis=-1)                          # (m, h)
    xc = jnp.einsum("nd,mhd->mnh", X, C,
                    preferred_element_type=jnp.float32,
                    precision=lax.Precision.HIGHEST)
    return c2[:, None, :] - 2.0 * xc


def _viterbi_chunk(u: Array, binaries: Array) -> Array:
    """Viterbi over one chunk. ``u``: (m, c, h) unaries; returns (c, m).

    Forward: f_{i+1}(b) = u_{i+1}(b) + min_a [f_i(a) + bin_i(a, b)],
    keeping the argmin table per stage; then backtrace.
    (Reference forward/backtrace: `src/ChainQ.jl:77-128`.)
    """
    m = u.shape[0]

    def fwd(f, inputs):
        ui, bi = inputs                                   # (c, h), (h, h)
        tot = f[:, :, None] + bi[None, :, :]              # (c, a, b)
        am = jnp.argmin(tot, axis=1).astype(jnp.int32)    # (c, h)
        f = ui + jnp.min(tot, axis=1)
        return f, am

    f_last, tables = lax.scan(fwd, u[0], (u[1:], binaries))

    b_last = jnp.argmin(f_last, axis=-1).astype(jnp.int32)  # (c,)

    def bwd(b_next, table):
        b = jnp.take_along_axis(table, b_next[:, None], axis=1)[:, 0]
        return b, b_next

    b_first, rest = lax.scan(bwd, b_last, tables, reverse=True)
    return jnp.concatenate([b_first[:, None], jnp.transpose(rest)], axis=1)


def viterbi_encode(X: Array, C: Array, chunk: int = 2048) -> Array:
    """Exact chain-optimal codes ``(n, m) int32`` for all vectors.

    The batched `quantize_chainq` encoder (reference
    `src/ChainQ.jl:305-348`, which dispatches to Julia/C++/CUDA
    backends)."""
    return _viterbi_encode_xla(X, C, chunk=chunk)


@partial(jax.jit, static_argnames=("chunk",))
def _viterbi_encode_xla(X: Array, C: Array, chunk: int = 2048) -> Array:
    n = X.shape[0]
    nchunks = cdiv(n, chunk)
    pad = nchunks * chunk - n
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    binaries = chain_binaries(C)
    u = chain_unaries(Xp, C)                              # (m, n', h)
    u = u.reshape(u.shape[0], nchunks, chunk, u.shape[2])
    B = lax.map(lambda uc: _viterbi_chunk(uc, binaries),
                jnp.transpose(u, (1, 0, 2, 3)))           # (nchunks, c, m)
    return B.reshape(-1, C.shape[0])[:n]
