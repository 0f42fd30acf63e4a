"""TPU-native chunked k-means (kmeans++ init, Lloyd, empty-cluster repick).

Replaces the reference's use of ``Clustering.kmeans`` (kmeans++ seeding,
<=25 Lloyd iterations, as invoked at reference `src/PQ.jl:84-87` and
`src/RVQ.jl:104`) and the incremental primitives ``update_assignments!``
/ ``update_centers!`` / repick-unused-centers it relies on.

TPU-first formulation:

* assignment = argmin of a pairwise-distance **matmul** (MXU), not a
  per-point loop;
* center update = one-hot-matmul **sufficient statistics** (counts,
  sums) — these are plain sums over the data axis, so under a device
  mesh they `psum` across shards (see `rayuela_tpu.parallel`);
* kmeans++ seeding = `lax.fori_loop` over k sequential picks with an
  incrementally maintained min-distance vector;
* empty clusters are repicked deterministically as the current
  highest-cost points (reference repicks randomly by cost; we accept
  statistical, not bitwise, parity — SURVEY.md §7 "k-means parity").

Everything is jit-compatible with static shapes and `vmap`-able over a
leading codebook axis (PQ trains all m subspace quantizers in one vmap).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rayuela_tpu.utils import one_hot, sqdist

Array = jax.Array


class KMeansResult(NamedTuple):
    centers: Array      # (k, d) float32
    assignments: Array  # (n,) int32
    objective: Array    # () float32 — mean squared distance to center


def assign(X: Array, centers: Array) -> tuple[Array, Array]:
    """Nearest-center assignment. Returns ``(assignments (n,), mind2 (n,))``.

    Semantics of ``Clustering.update_assignments!`` as used by the
    reference's PQ encoder (`src/PQ.jl:40-41`).
    """
    D = sqdist(X, centers)                   # (n, k) on the MXU
    a = jnp.argmin(D, axis=1).astype(jnp.int32)
    return a, jnp.min(D, axis=1)


def kmeanspp_init(key: Array, X: Array, k: int) -> Array:
    """kmeans++ seeding: k sequential picks, each sampled proportional to
    the squared distance to the nearest already-chosen center."""
    n, d = X.shape
    keys = jax.random.split(key, k)

    idx0 = jax.random.randint(keys[0], (), 0, n)
    c0 = lax.dynamic_index_in_dim(X, idx0, axis=0, keepdims=False)
    centers0 = jnp.zeros((k, d), X.dtype).at[0].set(c0)
    mind2_0 = jnp.sum((X - c0) ** 2, axis=-1)

    def body(i, state):
        centers, mind2 = state
        # Guard against all-zero mind2 (k > #distinct points): clamp so
        # categorical degrades to uniform over the zero set.
        logits = jnp.log(jnp.maximum(mind2, 1e-30))
        idx = jax.random.categorical(keys[i], logits)
        c = lax.dynamic_index_in_dim(X, idx, axis=0, keepdims=False)
        centers = lax.dynamic_update_index_in_dim(centers, c, i, axis=0)
        d2 = jnp.sum((X - c) ** 2, axis=-1)
        return centers, jnp.minimum(mind2, d2)

    centers, _ = lax.fori_loop(1, k, body, (centers0, mind2_0))
    return centers


def update_centers(X: Array, a: Array, k: int, old_centers: Array,
                   costs: Array | None = None, repick: bool = True) -> Array:
    """Center update from assignments: per-cluster means via one-hot-matmul
    sufficient statistics; clusters with no members keep their old value,
    or — with ``repick`` — are re-seeded with the currently most costly
    points (each empty cluster gets a distinct candidate, ranked by cost).

    Semantics of ``Clustering.update_centers!`` +
    ``repick_unused_centers`` as used at reference `src/ERVQ.jl:86-109`
    (deterministic repick — statistical parity, SURVEY.md §7).
    """
    oh = one_hot(a, k, dtype=jnp.float32)                       # exact {0,1}
    counts = jnp.sum(oh, axis=0)                                # (k,)
    # HIGHEST: a TF32/bf16 pass would round X's values inside the sum
    sums = jnp.matmul(oh.T, X, preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST)
    new_centers = jnp.where(
        (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None],
        old_centers)
    if not repick:
        return new_centers
    if costs is None:
        costs = jnp.sum((X - jnp.take(new_centers, a, axis=0)) ** 2, axis=-1)
    _, top_idx = lax.top_k(costs, k)
    cand = jnp.take(X, top_idx, axis=0)                         # (k, d)
    empty = counts == 0
    rank = jnp.cumsum(empty.astype(jnp.int32)) - 1              # (k,)
    return jnp.where(empty[:, None], jnp.take(cand, rank, axis=0),
                     new_centers)


def _lloyd_step(X: Array, centers: Array) -> tuple[Array, Array, Array]:
    """One Lloyd iteration with deterministic empty-cluster repick."""
    k = centers.shape[0]
    a, mind2 = assign(X, centers)
    new_centers = update_centers(X, a, k, centers, costs=mind2)
    return new_centers, a, jnp.mean(mind2)


def kmeans(key: Array, X: Array, k: int, iters: int = 25,
           init: str = "kmeanspp") -> KMeansResult:
    """Full k-means: seeding + ``iters`` Lloyd iterations.

    Matches the reference's faiss-compatible defaults (25 iterations,
    kmeans++ init — `src/PQ.jl:84-87`).
    """
    if init == "kmeanspp":
        centers = kmeanspp_init(key, X, k)
    elif init == "random":
        idx = jax.random.choice(key, X.shape[0], (k,), replace=False)
        centers = jnp.take(X, idx, axis=0)
    else:
        raise ValueError(f"unknown init {init!r}")

    def body(_, state):
        centers, _, _ = state
        return _lloyd_step(X, centers)

    n = X.shape[0]
    init_state = (centers, jnp.zeros((n,), jnp.int32), jnp.float32(0.0))
    centers, a, obj = lax.fori_loop(0, iters, body, init_state)
    # Final assignment against the last centers.
    a, mind2 = assign(X, centers)
    return KMeansResult(centers, a, jnp.mean(mind2))
