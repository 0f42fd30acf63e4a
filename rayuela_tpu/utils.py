"""Small shared helpers for the MCQ engine.

Design notes
------------
The reference (Rayuela.jl, see /root/reference) stores data as ``d x n``
column-major matrices and 1-based ``Int16`` codes (`src/utils.jl`,
`src/qerrors.jl`).  Here everything is row-major JAX convention:

* ``X  : (n, d)   float32``  — data, rows are vectors.
* ``C  : (m, h, d) float32`` — ``m`` codebooks of ``h`` centers each
  (full-dimensional methods); per-subspace methods (PQ/OPQ) use
  ``(m, h, d//m)``.
* ``B  : (n, m)   int32``    — 0-based codes (uint8 at I/O boundaries).

Row lookups (table gathers in `deps/src/linscan_aqd.cpp`, column
gathers in `deps/src/encode_icm.cpp`) are plain gathers: on the GPU a
gather reads only the rows it needs, and it is exact at any precision.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

Array = jax.Array


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return cdiv(x, m) * m


def splitarray(n: int, nparts: int) -> list[tuple[int, int]]:
    """Split ``range(n)`` into ``nparts`` balanced ``(start, size)`` chunks.

    Mirrors the balanced partitioning of Rayuela's ``splitarray``
    (reference `src/utils.jl:179-203`), used there to distribute work
    across Julia workers; here used for host-side chunking only (device
    partitioning goes through ``jax.sharding`` instead).
    """
    base, rem = divmod(n, nparts)
    out, start = [], 0
    for i in range(nparts):
        size = base + (1 if i < rem else 0)
        out.append((start, size))
        start += size
    return out


def one_hot(idx: Array, num: int, dtype=jnp.float32) -> Array:
    """One-hot encode ``idx`` with trailing dimension ``num``."""
    return jax.nn.one_hot(idx, num, dtype=dtype)


def sparsify_codes(B: Array, h: int, dtype=jnp.float32) -> Array:
    """Codes → (n, m*h) binary indicator matrix ("B_tilde").

    Reference ``sparsify_codes`` (`src/utils.jl:76-96`) builds a
    SparseMatrixCSC; on TPU the dense one-hot feeds the MXU directly
    (chunk the n axis for large n — see
    `rayuela_tpu.ops.codebook_update.codebook_stats`)."""
    n, m = B.shape
    return jax.nn.one_hot(B, h, dtype=dtype).reshape(n, m * h)


def K2vec(K: Array, m: int, h: int) -> Array:
    """Stacked least-squares solution (m*h, d) → codebooks (m, h, d).

    Reference ``K2vec`` (`src/utils.jl:99-114`)."""
    return K.reshape(m, h, -1)


def gather_rows(table: Array, idx: Array) -> Array:
    """Row gather ``table[idx]``: ``table`` (h, d), ``idx`` (n,) int →
    (n, d). Replaces every byte-indexed table lookup in the reference's
    native kernels (e.g. `deps/src/linscan_aqd.cpp:82-89`)."""
    return jnp.take(table, idx, axis=0)


def sqdist(X: Array, C: Array) -> Array:
    """Pairwise squared Euclidean distances ``(n, k)`` between rows of
    ``X (n, d)`` and rows of ``C (k, d)``.

    Same quantity as ``Distances.pairwise(SqEuclidean(), C, X)`` in the
    reference (`src/PQ.jl:40`), transposed to row-major convention.
    """
    x2 = jnp.sum(X * X, axis=-1, keepdims=True)            # (n, 1)
    c2 = jnp.sum(C * C, axis=-1)                           # (k,)
    xc = jnp.matmul(X, C.T, preferred_element_type=jnp.float32)
    return x2 - 2.0 * xc + c2[None, :]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here. Otherwise the cache goes to ``.jax_cache``
    at the root of the checkout (listed in ``.gitignore``), a fixed
    path so that later runs of the same checkout find it again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
