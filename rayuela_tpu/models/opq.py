"""Optimized Product Quantization (OPQ / Cartesian k-means).

Capability parity with reference `src/OPQ.jl` (``train_opq`` :49-139,
``quantize_opq`` :19-27): learn a global d x d rotation R jointly with
per-subspace codebooks. Per iteration: objective; R <- U V^T from the
SVD of the data/decode cross-covariance; one Lloyd step per subspace on
the re-rotated data (centers from OLD assignments, then re-assign; no
empty-cluster repick inside the loop — matching
``Clustering.update_centers!/update_assignments!`` as used there).

TPU-first: the m per-subspace center/assignment updates run as one
``vmap``; the SVD is a d x d (<= 1024^2) ``jnp.linalg.svd`` — tiny.
The whole training loop is one jit with ``lax.fori_loop``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu.models.pq import PQModel, _split_subspaces
from rayuela_tpu.ops.kmeans import assign
from rayuela_tpu.ops.qerror import reconstruct_pq
from rayuela_tpu.utils import one_hot

Array = jax.Array


class OPQModel(NamedTuple):
    codebooks: Array  # (m, h, d//m) float32
    R: Array          # (d, d) float32 orthonormal rotation


def _subspace_lloyd(C: Array, Xs: Array, B: Array) -> tuple[Array, Array]:
    """One OPQ-style Lloyd step for one subspace: update centers from the
    old assignments (empties keep their previous value), then re-assign."""
    h = C.shape[0]
    oh = one_hot(B, h)
    counts = jnp.sum(oh, axis=0)
    sums = jnp.matmul(oh.T, Xs, preferred_element_type=jnp.float32)
    C = jnp.where((counts > 0)[:, None],
                  sums / jnp.maximum(counts, 1.0)[:, None], C)
    a, _ = assign(Xs, C)
    return C, a


@partial(jax.jit, static_argnames=("m", "h", "niter", "init"))
def train_opq(key: Array, X: Array, m: int, h: int = 256,
              niter: int = 25, init: str = "natural"
              ) -> tuple[OPQModel, Array, Array]:
    """Train OPQ. Returns ``(model, codes (n, m), obj (niter+1,))``.

    ``init``: "natural" (R = identity) or "random" (random orthonormal)
    — reference `src/OPQ.jl:69-75`. Codebooks are initialized from h
    random data samples per subspace (`src/OPQ.jl:82-85`).
    """
    n, d = X.shape
    kr, ks = jax.random.split(key)

    if init == "natural":
        R = jnp.eye(d, dtype=X.dtype)
    elif init == "random":
        R, _, _ = jnp.linalg.svd(jax.random.normal(kr, (d, d), X.dtype))
    else:
        raise ValueError(f"unknown init {init!r}")

    def init_codebooks(R):
        Xr = jnp.matmul(X, R, preferred_element_type=jnp.float32)
        Xs = _split_subspaces(Xr, m)                      # (m, n, ds)
        perm = jax.random.choice(ks, n, (h,), replace=False)
        C = Xs[:, perm, :]                                # (m, h, ds)
        B, _ = jax.vmap(assign)(Xs, C)                    # (m, n)
        return C, B

    C0, B0 = init_codebooks(R)

    def body(it, state):
        C, B, R, obj = state
        # decode in rotated space, (n, d)
        Xhat = reconstruct_pq(C, jnp.transpose(B), d)
        Xr = jnp.matmul(X, R, preferred_element_type=jnp.float32)
        obj = obj.at[it].set(jnp.mean(jnp.sum((Xr - Xhat) ** 2, axis=-1)))
        # rotation update: R = U V^T from svd(X^T Xhat)
        U, _, Vt = jnp.linalg.svd(
            jnp.matmul(X.T, Xhat, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST),
            full_matrices=False)
        R = jnp.matmul(U, Vt, preferred_element_type=jnp.float32)
        # one Lloyd step per subspace on the re-rotated data
        Xs = _split_subspaces(
            jnp.matmul(X, R, preferred_element_type=jnp.float32), m)
        C, B = jax.vmap(_subspace_lloyd)(C, Xs, B)
        return C, B, R, obj

    obj0 = jnp.zeros((niter + 1,), jnp.float32)
    C, B, R, obj = lax.fori_loop(0, niter, body, (C0, B0, R, obj0))

    # final objective
    Xhat = reconstruct_pq(C, jnp.transpose(B), d)
    Xr = jnp.matmul(X, R, preferred_element_type=jnp.float32)
    obj = obj.at[niter].set(jnp.mean(jnp.sum((Xr - Xhat) ** 2, axis=-1)))

    return (OPQModel(codebooks=C, R=R),
            jnp.transpose(B, (1, 0)).astype(jnp.int32), obj)


def quantize_opq(model: OPQModel, X: Array, chunk: int = 65536) -> Array:
    """Encode: rotate, then PQ-assign per subspace (chunked over n).
    Reference `src/OPQ.jl:19-27`."""
    from rayuela_tpu.models.pq import PQModel, quantize_pq

    Xr = jnp.matmul(X, model.R, preferred_element_type=jnp.float32)
    return quantize_pq(PQModel(codebooks=model.codebooks), Xr,
                       chunk=chunk)
