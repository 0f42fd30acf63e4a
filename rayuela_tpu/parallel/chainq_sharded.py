"""Sharded ChainQ: data-parallel Viterbi + psum'd chain statistics.

The reference farms Viterbi encoding over Distributed workers and
stitches the per-worker code chunks back into a SharedArray
(`src/ChainQ.jl:334-344`); the chain codebook update runs on one
process. On the mesh both become one `shard_map` step:

* **Viterbi encoding** is embarrassingly parallel over vectors — each
  ``data`` shard encodes its slice with the replicated codebooks
  (`rayuela_tpu.ops.viterbi.viterbi_encode`, the Pallas kernel on TPU).
* **chain codebook update**: the (mh, mh)/(mh, d) normal-equation
  statistics are sums over n, so each shard accumulates its local
  (G, F), one `psum` over ICI makes them global, and the batched
  (2h, 2h) block solves (`ops.codebook_update._chain_solve`) run
  replicated — the same stats-psum/solve-replicated shape as the
  sharded LSQ step (SURVEY.md §2.5).
* **rotation update**: the d x d cross-covariance X^T X_hat is also a
  sum over n → local matmul + psum, replicated SVD.

Ragged n is handled exactly: pad rows carry code -1, whose all-zero
one-hot contributes nothing to (G, F) (`codebook_stats` semantics),
zero data so the cross-covariance is exact, and a validity mask keeps
them out of the objective.
"""

from __future__ import annotations

import functools as _functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rayuela_tpu.models.chainq import ChainQModel
from rayuela_tpu.ops.codebook_update import _chain_solve, codebook_stats
from rayuela_tpu.ops.qerror import reconstruct
from rayuela_tpu.ops.viterbi import viterbi_encode

Array = jax.Array


@_functools.lru_cache(maxsize=32)
def _sharded_viterbi_fn(mesh: Mesh, chunk: int):
    from jax import shard_map

    def local(X, C):
        return viterbi_encode(X, C, chunk=chunk)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data", None), P()),
                   out_specs=P("data", None), check_vma=False)
    return jax.jit(fn)


def sharded_viterbi_encode(mesh: Mesh, X: Array, C: Array, *,
                           chunk: int = 2048) -> Array:
    """Data-parallel exact Viterbi encode over the ``data`` mesh axis
    (the device-mesh mapping of `src/ChainQ.jl:334-344`'s worker farm). ``X``
    may be ragged; pad rows are encoded and discarded."""
    ndata = mesh.shape["data"]
    n = X.shape[0]
    pad = -n % ndata
    if pad:
        X = jnp.pad(X, ((0, pad), (0, 0)))
    B = _sharded_viterbi_fn(mesh, chunk)(X, jnp.asarray(C))
    return B[:n]


@_functools.lru_cache(maxsize=16)
def _chainq_step_fns(mesh: Mesh, h: int, d: int, m: int, chunk: int):
    """Build-and-cache the jitted init / iteration / objective steps of
    the sharded ChainQ trainer (one compile each; `it`, keys and masks
    are traced so the host loop reuses the executables)."""
    from jax import lax, shard_map

    def _stats_solve(RX, B):
        G, F = codebook_stats(RX, B, h, chunk=16384)
        G = lax.psum(G, "data")
        F = lax.psum(F, "data")
        return _chain_solve(G, F, h=h, d=d, m=m, rho=1e-4)

    def _masked_obj(RX, C, B, mask, nvalid):
        res = RX - reconstruct(C, B)
        res = jnp.where(mask[:, None], res, 0.0)
        return lax.psum(jnp.sum(res * res), "data") / nvalid

    def _encode(RX, C, mask):
        B = viterbi_encode(RX, C, chunk=chunk)
        return jnp.where(mask[:, None], B, -1)

    def init_local(X, B0, R0, mask):
        # reference `src/ChainQ.jl:396-403`: codebooks from the init
        # codes, then one re-encode
        RX = jnp.matmul(X, R0, preferred_element_type=jnp.float32)
        C0 = _stats_solve(RX, B0)
        return C0, _encode(RX, C0, mask)

    def iter_local(X, C, B, R, mask, nvalid):
        # reference `src/ChainQ.jl:405-425` loop body: objective, R
        # from SVD of X^T X_hat, chain solve on rotated data, Viterbi
        RX = jnp.matmul(X, R, preferred_element_type=jnp.float32)
        obj = _masked_obj(RX, C, B, mask, nvalid)
        Xhat = reconstruct(C, B)
        Xhat = jnp.where(mask[:, None], Xhat, 0.0)
        cross = lax.psum(
            jnp.matmul(X.T, Xhat, preferred_element_type=jnp.float32,
                       precision=lax.Precision.HIGHEST), "data")
        U, _, Vt = jnp.linalg.svd(cross, full_matrices=False)
        R = jnp.matmul(U, Vt, preferred_element_type=jnp.float32)
        RX = jnp.matmul(X, R, preferred_element_type=jnp.float32)
        C = _stats_solve(RX, B)
        return obj, C, _encode(RX, C, mask), R

    def obj_local(X, C, B, R, mask, nvalid):
        RX = jnp.matmul(X, R, preferred_element_type=jnp.float32)
        return _masked_obj(RX, C, B, mask, nvalid)

    dn = P("data", None)
    init = shard_map(init_local, mesh=mesh,
                     in_specs=(dn, dn, P(), P("data")),
                     out_specs=(P(), dn), check_vma=False)
    step = shard_map(iter_local, mesh=mesh,
                     in_specs=(dn, P(), dn, P(), P("data"), P()),
                     out_specs=(P(), P(), dn, P()),
                     check_vma=False)
    obj = shard_map(obj_local, mesh=mesh,
                    in_specs=(dn, P(), dn, P(), P("data"), P()),
                    out_specs=P(), check_vma=False)
    return jax.jit(init), jax.jit(step), jax.jit(obj)


def train_chainq_sharded(mesh: Mesh, X, B0, R0, *, h: int = 256,
                         niter: int = 25, chunk: int = 2048
                         ) -> tuple[ChainQModel, Array, Array]:
    """`models.chainq.train_chainq` over a device mesh: same math, same
    return contract ``(model, codes (n, m), obj (niter+1,))``. The n
    axis shards over ``data``; codebooks, rotation and the solves
    replicate. Bitwise it differs from the single-device trainer only
    by psum reduction order (fp summation) — asserted ~equal in
    `tests/test_parallel.py` and the multichip dryrun."""
    X = jnp.asarray(X, jnp.float32)
    B0 = jnp.asarray(B0, jnp.int32)
    R0 = jnp.asarray(R0, jnp.float32)
    n, d = X.shape
    m = B0.shape[1]
    ndata = mesh.shape["data"]
    pad = -n % ndata
    mask = np.ones((n + pad,), bool)
    if pad:
        X = jnp.pad(X, ((0, pad), (0, 0)))
        B0 = jnp.pad(B0, ((0, pad), (0, 0)), constant_values=-1)
        mask[n:] = False
    shd = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    X = jax.device_put(X, shd)
    B0 = jax.device_put(B0, shd)
    R0 = jax.device_put(R0, rep)
    maskj = jax.device_put(jnp.asarray(mask),
                           NamedSharding(mesh, P("data")))
    nvalid = jax.device_put(jnp.float32(n), rep)

    init, step, objf = _chainq_step_fns(mesh, h, d, m, chunk)
    C, B = init(X, B0, R0, maskj)
    R = R0
    objs = []
    for _ in range(niter):
        o, C, B, R = step(X, C, B, R, maskj, nvalid)
        objs.append(o)
    objs.append(objf(X, C, B, R, maskj, nvalid))
    return ChainQModel(codebooks=C, R=R), B[:n], jnp.stack(objs)
