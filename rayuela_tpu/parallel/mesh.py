"""Device-mesh layout and sharded execution for the MCQ engine.

The reference's complete parallelism inventory (SURVEY.md §2.5 —
Julia ``Distributed`` workers + ``SharedArrays`` on one machine,
OpenMP threads inside the C++ kernels) maps here to one idiom:
a `jax.sharding.Mesh` with named axes and GSPMD partitioning.

Axes:
  * ``data``  — the n axis (training vectors / base-set codes). All
    training statistics (k-means counts/sums, fastbin B^T B / B^T X,
    objectives) are sums over n, so XLA inserts `psum` (NCCL on the
    GPU) when X is sharded on ``data``.
  * ``model`` — the m axis (codebooks / subspaces). PQ/OPQ train m
    independent quantizers; sharding the leading vmap axis over
    ``model`` is tensor parallelism with zero communication.

Search: base codes sharded on ``data``, queries replicated; each shard
scans locally and keeps a local top-k; the (nq, k) partial lists
all-gather and merge — k ≪ n, so the collective is tiny (SURVEY.md
§2.5 north-star mapping).
"""

from __future__ import annotations

import functools as _functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = devices.size // n_model
    devices = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(devices, ("data", "model"))


def shard_data(mesh: Mesh, x: Array, axis: int = 0) -> Array:
    """Place ``x`` sharded along ``axis`` over the ``data`` mesh axis."""
    spec = [None] * x.ndim
    spec[axis] = "data"
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def replicate(mesh: Mesh, x: Array) -> Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_to_multiple(x: Array, mult: int, axis: int = 0, fill=0):
    """Pad ``x`` along ``axis`` to a multiple of ``mult`` (shard-evenly)."""
    n = x.shape[axis]
    pad = -n % mult
    if pad == 0:
        return x, n
    cfg = [(0, 0)] * x.ndim
    cfg[axis] = (0, pad)
    return jnp.pad(x, cfg, constant_values=fill), n


@_functools.lru_cache(maxsize=64)
def _sharded_scan_fn(mesh: Mesh, n: int, shard_n: int, klocal: int,
                     k: int, pq: bool, have_norms: bool, tile: int):
    """Build-and-cache the jitted sharded scan for one (mesh, shape,
    statics) signature — re-jitting per call was the 1-device ~2x
    wrapper overhead (every search retraced and recompiled)."""
    from jax import shard_map

    from rayuela_tpu.search.linscan import scan_topk

    ndata = mesh.shape["data"]

    def local(Q, C, B, nt):
        # Each shard scans its slice; ids are local → offset by shard.
        d, i = scan_topk(Q, C, B, k=klocal, pq=pq,
                         norm_term=nt if have_norms else None, tile=tile)
        shard = jax.lax.axis_index("data")
        i = i + shard * shard_n
        d = jnp.where(i < n, d, jnp.inf)
        if ndata == 1:                 # static: no merge needed
            return d[:, :k], i[:, :k]
        # All-gather partial lists along the k axis, merge with top_k.
        dg = jax.lax.all_gather(d, "data", axis=1, tiled=True)  # (nq, P*k)
        ig = jax.lax.all_gather(i, "data", axis=1, tiled=True)
        neg, loc = jax.lax.top_k(-dg, k)
        return -neg, jnp.take_along_axis(ig, loc, axis=1)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P("data", None), P("data")),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)


def sharded_scan_topk(mesh: Mesh, Q: Array, C: Array, B: Array, *,
                      k: int, pq: bool = False,
                      norm_term: Array | None = None,
                      tile: int = 1 << 14):
    """Data-parallel ADC scan: codes sharded over ``data``, queries
    replicated; local top-k per shard, then a top-k merge of the
    all-gathered partial lists (exact — the global top-k is contained in
    the union of per-shard top-k).

    The device-mesh replacement for the reference's OpenMP scan over
    one host's memory (`deps/src/linscan_aqd.cpp:55-61`); the merge is
    the all-gather step of SURVEY.md §2.5. Also the exact XLA repair
    of `sharded_search_exact`.
    """
    ndata = mesh.shape["data"]
    Bp, n = pad_to_multiple(B, ndata)
    shard_n = Bp.shape[0] // ndata
    have_norms = norm_term is not None
    if have_norms:
        nt, _ = pad_to_multiple(norm_term, ndata, fill=jnp.inf)
    else:  # placeholder so the shard_map signature is static
        nt = jnp.zeros((Bp.shape[0],), jnp.float32)

    # Padded rows decode to finite scores; requesting `pad` extra local
    # candidates keeps the merge exact even if fake rows rank high.
    klocal = min(k + (Bp.shape[0] - n), shard_n)
    fn = _sharded_scan_fn(mesh, n, shard_n, klocal, k, pq, have_norms,
                          tile)
    return fn(Q, C, Bp, nt)


def _merge_shards(d, i, fl, *, n: int, shard_n: int, k: int,
                  klocal: int, ndata: int):
    """Inside `shard_map`: offset a shard's local ids, mask mesh-pad
    rows, and merge the per-shard (nq, klocal) lists with one
    all-gather + top-k; certificate flags OR across shards."""
    i = i + jax.lax.axis_index("data") * shard_n
    d = jnp.where(i < n, d, jnp.inf)
    if ndata == 1:                 # static: no merge needed
        kk = min(k, klocal)
        return d[:, :kk], i[:, :kk], fl
    dg = jax.lax.all_gather(d, "data", axis=1, tiled=True)
    ig = jax.lax.all_gather(i, "data", axis=1, tiled=True)
    neg, loc = jax.lax.top_k(-dg, min(k, ndata * klocal))
    fl = jax.lax.psum(fl.astype(jnp.int32), "data") > 0
    return -neg, jnp.take_along_axis(ig, loc, axis=1), fl


def _use_kernel(interpret: bool) -> bool:
    from rayuela_tpu import platform
    return interpret or platform.on_gpu()


@_functools.lru_cache(maxsize=64)
def _sharded_search_fn(mesh: Mesh, n: int, shard_n: int, klocal: int,
                       k: int, interpret: bool, cfg: tuple):
    from jax import shard_map

    from rayuela_tpu.search.linscan import exact_rescan
    from rayuela_tpu.search.scan_kernel import scan_topk_decoded

    ndata = mesh.shape["data"]

    def local(Q, Xd, x2):
        out = None
        if _use_kernel(interpret):
            out = scan_topk_decoded(Q, Xd, x2, klocal,
                                    interpret=interpret, **dict(cfg))
        if out is None:
            d, i = exact_rescan(Q, Xd, x2, klocal)
            fl = jnp.zeros((Q.shape[0],), jnp.bool_)
        else:
            d, i, fl = out
            d = d + jnp.sum(Q * Q, axis=-1, keepdims=True)
        return _merge_shards(d, i, fl, n=n, shard_n=shard_n, k=k,
                             klocal=klocal, ndata=ndata)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P("data", None), P("data")),
                   out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(fn)


def sharded_search(mesh: Mesh, Xd: Array, x2: Array, Q: Array, *,
                   k: int, interpret: bool = False, **cfg):
    """Multi-device search over a DECODED index: the index shards over
    ``data`` (each device holds n/P decoded rows), queries replicate,
    each device runs the single-device route on its shard (the scan
    kernel on the GPU or with ``interpret=True``, `exact_rescan` on the
    CPU), and the (nq, k) partial lists merge with one all-gather +
    top-k.

    Returns ``(dists, ids, flagged)`` as true squared distances;
    flagged queries (a shard's certificate flagged them) should re-run
    through an exact path — `sharded_search_exact` does that. The
    jitted executable is cached per (mesh, shapes, statics)."""
    ndata = mesh.shape["data"]
    Xp, n = pad_to_multiple(Xd, ndata)
    x2p, _ = pad_to_multiple(x2, ndata, fill=jnp.inf)
    shard_n = Xp.shape[0] // ndata
    klocal = min(k, shard_n)
    fn = _sharded_search_fn(mesh, n, shard_n, klocal, k, interpret,
                            tuple(sorted(cfg.items())))
    return fn(jnp.asarray(Q, jnp.float32), Xp, x2p)


@_functools.lru_cache(maxsize=64)
def _sharded_search_codes_fn(mesh: Mesh, n: int, shard_n: int,
                             klocal: int, k: int, pq: bool, d: int,
                             m: int, h: int, mprime: int, has_norms: bool,
                             interpret: bool, cfg: tuple):
    from jax import shard_map

    from rayuela_tpu.search.codes import build_luts, unpack_codes, \
        xla_lut_scan
    from rayuela_tpu.search.scan_kernel import scan_topk_codes

    ndata = mesh.shape["data"]

    def local(Q, C, nc, Cf, nrm, packed):
        out = None
        if _use_kernel(interpret):
            out = scan_topk_codes(Q, packed, Cf, nrm, klocal, pq=pq, m=m,
                                  h=h, interpret=interpret, **dict(cfg))
        if out is None:
            T = build_luts(C, Q, pq=pq, d=d,
                           norms_cbook=nc if has_norms else None)
            s, i = xla_lut_scan(T, unpack_codes(packed, mprime), klocal)
            fl = jnp.zeros((Q.shape[0],), jnp.bool_)
        else:
            s, i, fl = out
        return _merge_shards(s, i, fl, n=n, shard_n=shard_n, k=k,
                             klocal=klocal, ndata=ndata)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P(), P("data", None)),
                   out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(fn)


def sharded_search_codes(mesh: Mesh, Q: Array, C: Array, packed: Array,
                         *, k: int, pq: bool, d: int | None = None,
                         norms_cbook: Array | None = None,
                         interpret: bool = False, **cfg):
    """Multi-device CODE-RESIDENT search: packed codes shard over
    ``data`` (each device holds n/P * ~m bytes), queries and codebooks
    replicate, each device runs the single-device route on its shard
    (the scan kernel's in-kernel decode on the GPU or with
    ``interpret=True``; the XLA LUT scan on the CPU), and the (nq, k)
    partial lists merge with one all-gather + top-k — the reference's
    multi-worker LUT scan (`deps/src/linscan_aqd.cpp:55-61`) across
    devices.

    ``packed`` from `codes.pack_codes` (norms byte included for
    additive methods). Returns ``(scores, ids, flagged)``; scores
    exclude the +|q|^2 constant."""
    from rayuela_tpu import platform
    from rayuela_tpu.search.scan_kernel import decode_operands

    m, h = C.shape[0], C.shape[1]
    Q = jnp.asarray(Q, jnp.float32)
    d = Q.shape[1] if d is None else d
    dtype = jnp.float32 if interpret else platform.operand_dtype()
    Cf, nrm = decode_operands(C, pq=pq, d=d, norms_cbook=norms_cbook,
                              dtype=dtype)
    nc = (jnp.zeros((1,), jnp.float32) if norms_cbook is None
          else jnp.asarray(norms_cbook, jnp.float32))
    ndata = mesh.shape["data"]
    Pp, n = pad_to_multiple(packed, ndata)
    shard_n = Pp.shape[0] // ndata
    # Mesh-pad rows unpack to code 0 with finite scores; they are
    # dropped by the i < n mask after the scan, so over-fetch by the
    # pad count to keep the merge exact even if they rank high.
    klocal = min(k + (Pp.shape[0] - n), shard_n)
    mprime = m + (norms_cbook is not None)
    fn = _sharded_search_codes_fn(mesh, n, shard_n, klocal, k, pq, d, m,
                                  h, mprime, norms_cbook is not None,
                                  interpret, tuple(sorted(cfg.items())))
    return fn(Q, jnp.asarray(C, jnp.float32), nc, Cf, nrm, Pp)


def sharded_search_exact(mesh: Mesh, Xd: Array, x2: Array, Q: Array, *,
                         C: Array | None = None, B: Array | None = None,
                         pq: bool = False,
                         norm_term: Array | None = None,
                         k: int, **kw) -> tuple[Array, Array]:
    """`sharded_search` plus the single-device contract: queries the
    certificate flags re-run through the exact XLA sharded scan
    (needs ``C``/``B`` to rebuild scores) or an exact decoded rescan
    over the gathered rows when codes are not provided. Returns
    ``(dists, ids)`` exact, always."""
    d, i, fl = sharded_search(mesh, Xd, x2, Q, k=k, **kw)
    flagged = np.asarray(fl)
    if flagged.any():
        qidx = np.nonzero(flagged)[0]
        Qf = jnp.asarray(Q)[qidx]
        if C is not None and B is not None:
            d2, i2 = sharded_scan_topk(mesh, Qf, C, B, k=k, pq=pq,
                                       norm_term=norm_term)
        else:
            from rayuela_tpu.search.linscan import exact_rescan
            d2, i2 = exact_rescan(Qf, Xd, x2, k=min(k, Xd.shape[0]))
        d = d.at[qidx].set(d2)
        i = i.at[qidx].set(i2)
    return d, i


@partial(jax.jit, static_argnames=("h",), donate_argnums=(1,))
def pq_lloyd_step_sharded(Xs: Array, centers: Array, h: int):
    """One data-parallel + model-parallel Lloyd step over all m subspace
    quantizers at once.

    ``Xs``: (m, n, ds) — n sharded over ``data``, m over ``model``.
    ``centers``: (m, h, ds) — m sharded over ``model``.

    The sufficient statistics (one-hot counts and sums) are sums over
    the sharded n axis, so GSPMD lowers the center update to local
    matmuls + `psum` across devices — the equivalent of the reference
    farming chunks to Julia workers (`src/codebook_update.jl:258-270`).
    """
    from rayuela_tpu.ops.kmeans import assign, update_centers

    def step(X, c):
        a, mind2 = assign(X, c)
        return update_centers(X, a, h, c, costs=mind2), jnp.sum(mind2)

    new_centers, obj = jax.vmap(step)(Xs, centers)
    return new_centers, jnp.sum(obj) / (Xs.shape[0] * Xs.shape[1])
