"""High-level facade: train / encode / search in three calls.

The reference exposes per-method functions and demo scripts; this
module adds the one-call surface a production user expects, on top of
the same primitives:

    import rayuela_tpu.api as rq
    model = rq.train(Xt, method="sr_d", m=7, h=256)     # any method
    index = rq.index_base(model, Xb)                    # encode + decode-index
    dists, ids = rq.search(index, Q, k=100)             # fused scan
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

METHODS = ("pq", "opq", "rvq", "ervq", "chainq", "lsq", "sr_c", "sr_d",
           "compq")
_ORTHOGONAL = ("pq", "opq")


@dataclass
class MCQModel:
    """A trained quantizer: codebooks + method metadata."""
    method: str
    codebooks: Array               # (m, h, d*) f32
    R: Array | None = None         # rotation (OPQ / ChainQ)
    h: int = 256
    train_codes: Array | None = None
    extras: dict = field(default_factory=dict)

    @property
    def pq_layout(self) -> bool:
        return self.method in _ORTHOGONAL


@dataclass
class MCQIndex:
    """A searchable base set: codes + scan index + norms.

    ``mode="decoded"`` keeps an (n, d) decode on the device (bf16 on
    the GPU); ``mode="codes"`` keeps only the packed uint8 codes
    (~m bytes/vector — 32x smaller at d=128, m=8; the reference's
    deployment memory model)."""
    model: MCQModel
    codes: Array                   # (n, m) int32
    scan_index: Any                # LinscanIndex | CodesIndex
    norms_codebook: Array | None = None
    norm_codes: Array | None = None
    mode: str = "decoded"


def train(Xt, method: str = "sr_d", m: int = 8, h: int = 256,
          niter: int = 25, key=None, mesh=None, **kw) -> MCQModel:
    """Train any MCQ method with the reference pipeline semantics
    (staged OPQ → ChainQ init for the LSQ family). The final stage's
    objective per iteration is kept in ``extras["train_error"]``.

    Pass ``mesh`` (a `rayuela_tpu.parallel.mesh.make_mesh` result) to
    train data-parallel across the mesh's devices: ChainQ and the LSQ
    family route to the explicit `shard_map` steps in
    `rayuela_tpu.parallel` (psum'd normal-equation stats + replicated
    solves, per-shard Viterbi/ICM encoding — the device-mesh mapping of
    the reference's Distributed-worker farm, `src/Rayuela.jl:10,31`); the
    remaining methods run with ``Xt`` sharded over the ``data`` axis so
    GSPMD inserts the collectives for their matmul/reduction training
    statistics."""
    from rayuela_tpu import models as M

    method = method.lower()
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    key = jax.random.PRNGKey(0) if key is None else key
    Xt = jnp.asarray(Xt)
    if mesh is not None:
        if method in ("chainq", "lsq", "sr_c", "sr_d"):
            return _train_sharded(mesh, key, Xt, method, m, h, niter,
                                  **kw)
        from rayuela_tpu.parallel.mesh import shard_data
        Xt = shard_data(mesh, Xt)

    if method == "pq":
        model, B, obj = M.train_pq(key, Xt, m, h, iters=niter, **kw)
        return MCQModel("pq", model.codebooks, h=h, train_codes=B,
                        extras={"train_error": obj})
    if method == "opq":
        model, B, obj = M.train_opq(key, Xt, m, h, niter=niter, **kw)
        return MCQModel("opq", model.codebooks, R=model.R, h=h,
                        train_codes=B, extras={"train_error": obj})
    if method == "rvq":
        model, B, obj = M.train_rvq(key, Xt, m, h, niter=niter, **kw)
        return MCQModel("rvq", model.codebooks, h=h, train_codes=B,
                        extras={"train_error": obj})
    if method == "ervq":
        model, B, obj = M.train_ervq_from_scratch(key, Xt, m, h,
                                                  niter=niter, **kw)
        return MCQModel("ervq", model.codebooks, h=h, train_codes=B,
                        extras={"train_error": obj})
    if method == "compq":
        rvq, B0, _ = M.train_rvq(key, Xt, m, h, niter=niter)
        model, B, obj = M.train_compq(Xt, rvq.codebooks, B0,
                                      niter=niter, **kw)
        return MCQModel("compq", model.codebooks, h=h, train_codes=B,
                        extras={"train_error": obj})

    # LSQ family: OPQ → ChainQ → {chainq | lsq | sr}
    opq, B0, _ = M.train_opq(key, Xt, m, h, niter=niter)
    if method == "chainq":
        model, B, obj = M.train_chainq(Xt, B0, opq.R, h=h,
                                       niter=niter, **kw)
        return MCQModel("chainq", model.codebooks, R=model.R, h=h,
                        train_codes=B, extras={"train_error": obj})
    cq, B1, _ = M.train_chainq(Xt, B0, opq.R, h=h, niter=niter)
    if method == "lsq":
        model, B, obj = M.train_lsq(key, Xt, B1, cq.R, h=h,
                                    niter=niter, **kw)
    else:
        model, B, obj = M.train_sr(key, Xt, B1, cq.R, h=h, niter=niter,
                                   method=method.upper(), **kw)
    return MCQModel(method, model.codebooks, h=h, train_codes=B,
                    extras={"train_error": obj})


def _train_sharded(mesh, key, Xt, method: str, m: int, h: int,
                   niter: int, **kw) -> MCQModel:
    """mesh= path of `train` for ChainQ and the LSQ family: staged
    OPQ (GSPMD-sharded) → sharded ChainQ → sharded LSQ/SR steps."""
    from rayuela_tpu import models as M
    from rayuela_tpu.parallel.chainq_sharded import train_chainq_sharded
    from rayuela_tpu.parallel.lsq_sharded import train_lsq_family_sharded
    from rayuela_tpu.parallel.mesh import shard_data

    opq, B0, _ = M.train_opq(key, shard_data(mesh, Xt), m, h,
                             niter=niter)
    if method == "chainq":
        model, B, obj = train_chainq_sharded(mesh, Xt, B0, opq.R, h=h,
                                             niter=niter, **kw)
        return MCQModel("chainq", model.codebooks, R=model.R, h=h,
                        train_codes=B, extras={"train_error": obj})
    cqm, B1, _ = train_chainq_sharded(mesh, Xt, B0, opq.R, h=h,
                                      niter=niter)
    name = {"lsq": "LSQ", "sr_c": "SR_C", "sr_d": "SR_D"}[method]
    model, B, obj = train_lsq_family_sharded(mesh, key, Xt, B1, cqm.R,
                                             h=h, niter=niter,
                                             method=name, **kw)
    return MCQModel(method, model.codebooks, h=h, train_codes=B,
                    extras={"train_error": obj})


def encode(model: MCQModel, X, key=None, **kw) -> Array:
    """Encode vectors with a trained model (method-appropriate path)."""
    from rayuela_tpu import models as M
    from rayuela_tpu.ops.icm import encoding_icm

    X = jnp.asarray(X)
    key = jax.random.PRNGKey(1) if key is None else key
    method = model.method
    if method == "pq":
        from rayuela_tpu.models.pq import PQModel
        return M.quantize_pq(PQModel(model.codebooks), X, **kw)
    if method == "opq":
        from rayuela_tpu.models.opq import OPQModel
        return M.quantize_opq(OPQModel(model.codebooks, model.R), X, **kw)
    if method in ("rvq", "ervq"):
        B, _ = M.quantize_rvq(model.codebooks, X)
        return B
    if method == "chainq":
        from rayuela_tpu.models.chainq import ChainQModel
        return M.quantize_chainq(ChainQModel(model.codebooks, model.R),
                                 X, **kw)
    if method == "compq":
        B, _ = M.quantize_compq(model.codebooks, X, **kw)
        return B
    # LSQ family: greedy init + ILS/ICM with the 4x base budget
    B0, _ = M.quantize_rvq(model.codebooks, X)
    kw.setdefault("ilsiter", 32)
    return encoding_icm(key, X, model.codebooks, B0, **kw)


def index_base(model: MCQModel, Xb, key=None, mode: str = "decoded",
               **kw) -> MCQIndex:
    """Encode the base set and build the scan index (+ norms byte for
    non-orthogonal methods). ``mode="codes"`` builds the code-resident
    index (~m bytes/vector on the device) instead of the decoded one."""
    from rayuela_tpu.search.codes import build_codes_index
    from rayuela_tpu.search.linscan import build_index
    from rayuela_tpu.search.norms import get_norms_codebook, quantize_norms

    if mode not in ("decoded", "codes"):
        raise ValueError(f"mode {mode!r}: 'decoded' or 'codes'")
    Xb = jnp.asarray(Xb)
    key = jax.random.PRNGKey(2) if key is None else key
    B = encode(model, Xb, key=key, **kw)
    norms_cb = norm_codes = None
    if not model.pq_layout and model.train_codes is not None:
        # the code-resident index stacks the norms table with the (h,·)
        # per-codebook LUTs, so cap its size at h (the reference's full
        # norms byte = 256 entries is the h=256 protocol case)
        nh = min(256, model.h) if mode == "codes" else 256
        _, norms_cb = get_norms_codebook(key, model.codebooks,
                                         model.train_codes, h=nh)
        norm_codes, _ = quantize_norms(model.codebooks, B, norms_cb)
        nt = jnp.take(norms_cb, norm_codes)
    else:
        nt = None
    if mode == "codes":
        idx = build_codes_index(model.codebooks, B, pq=model.pq_layout,
                                d=Xb.shape[1], norms_cbook=norms_cb,
                                norms_codes=norm_codes)
    else:
        idx = build_index(model.codebooks, B, pq=model.pq_layout,
                          d=Xb.shape[1], norm_term=nt)
    return MCQIndex(model, B, idx, norms_cb, norm_codes, mode=mode)


def search(index: MCQIndex, Q, k: int = 100, mesh=None,
           **kw) -> tuple[Array, Array]:
    """Top-k ADC search (rotates queries when the model has R).

    On the GPU each index type runs the fused scan kernel
    (`rayuela_tpu.search.scan_kernel`) and repairs the queries its
    certificate flags with the exact XLA oracle; on the CPU the oracle
    runs alone. ``interpret=True`` (tests) runs the kernel in
    interpret mode instead.

    Pass ``mesh`` (a `rayuela_tpu.parallel.mesh.make_mesh` result) to
    run the search data-parallel across the mesh's devices: the index
    shards over the ``data`` axis, local top-k lists merge with one
    all-gather, and certificate-flagged queries re-run exactly — the
    same exactness contract as the single-device path."""
    from rayuela_tpu.search import codes, linscan

    Q = jnp.asarray(Q, jnp.float32)
    if index.model.R is not None and index.model.method in ("chainq",
                                                            "opq"):
        Q = jnp.matmul(Q, index.model.R,
                       preferred_element_type=jnp.float32)
    k = min(k, index.scan_index.n)
    if mesh is None:
        if index.mode == "codes":
            return codes.search_codes(index.scan_index, Q, k, **kw)
        return linscan.search(index.scan_index, Q, k, **kw)

    from rayuela_tpu.parallel import mesh as pmesh

    if index.mode == "codes":
        si = index.scan_index
        d = Q.shape[1] if si.d in (-1, None) else si.d
        lut_dtype = kw.pop("lut_dtype", jnp.float32)
        s, i, fl = pmesh.sharded_search_codes(
            mesh, Q, index.model.codebooks, si.packed, k=k,
            pq=index.model.pq_layout, d=d,
            norms_cbook=index.norms_codebook, **kw)
        fl = np.asarray(fl)
        if fl.any():
            # flagged queries re-run through the TILED XLA LUT oracle
            # (segment x query-block merge): a whole-base unpack plus
            # an (nflagged, n) score matrix would not fit at n >= 1e8
            qidx = np.nonzero(fl)[0]
            s2, i2 = codes._xla_lut_scan_tiled(si, Q[qidx], k, d,
                                               lut_dtype)
            s = s.at[qidx].set(s2)
            i = i.at[qidx].set(i2)
        return s + jnp.sum(Q * Q, axis=-1, keepdims=True), i
    nt = (None if index.norms_codebook is None else
          jnp.take(index.norms_codebook, index.norm_codes))
    return pmesh.sharded_search_exact(
        mesh, index.scan_index.Xd, index.scan_index.x2, Q, k=k,
        C=index.model.codebooks, B=index.codes,
        pq=index.model.pq_layout, norm_term=nt, **kw)


def search_streamed(model: MCQModel, B_packed, Q, k: int = 100,
                    norms_cbook=None, mprime: int | None = None,
                    shard_n: int = 100_000_000,
                    **kw) -> tuple[Array, Array]:
    """Top-k ADC search over a base TOO LARGE for device memory: the
    packed codes stay in HOST memory (a numpy array or an `np.memmap`
    over an on-disk code file, `rayuela_tpu.search.codes.pack_codes`
    layout — norms byte included for additive methods) and stream
    through the device shard by shard with an exact host-side merge;
    the next shard's transfer is prefetched behind the current shard's
    scan.

    The facade rung of the memory-tiling ladder above
    ``index_base(mode="codes")`` (reference ``nsplits``,
    `src/LSQ_GPU.jl:218-264`): bases bounded only by host RAM/disk.
    Rotates queries for OPQ/ChainQ models like `search`."""
    from rayuela_tpu.search.codes import search_codes_streamed

    Q = jnp.asarray(Q, jnp.float32)
    if model.R is not None and model.method in ("opq", "chainq"):
        Q = jnp.matmul(Q, model.R, preferred_element_type=jnp.float32)
    return search_codes_streamed(
        model.codebooks, B_packed, Q, k, pq=model.pq_layout,
        norms_cbook=norms_cbook, mprime=mprime, shard_n=shard_n, **kw)


# ---------------------------------------------------------------------------
# Persistence: HDF5 save/load for models and indexes
# ---------------------------------------------------------------------------

def _put(g, name, arr):
    if arr is not None:
        g.create_dataset(name, data=np.asarray(arr))


def save_model(path: str, model: MCQModel) -> None:
    """Persist a trained model to HDF5 (same storage conventions as the
    reference's result files, `demos/experiment_utils.jl:5-43`:
    f32 codebooks, 0-based uint8 codes)."""
    import h5py
    with h5py.File(path, "w") as f:
        g = f.create_group("model")
        _write_model(g, model)


def _write_model(g, model: MCQModel) -> None:
    g.attrs["method"] = model.method
    g.attrs["h"] = model.h
    _put(g, "codebooks", model.codebooks)
    _put(g, "R", model.R)
    if model.train_codes is not None:
        _put(g, "train_codes", _codes_np(model.train_codes, model.h))


def _codes_np(B, h: int) -> np.ndarray:
    B = np.asarray(B)
    return B.astype(np.uint8) if h <= 256 else B.astype(np.int32)


def _read_model(g) -> MCQModel:
    tc = g.get("train_codes")
    return MCQModel(
        method=str(g.attrs["method"]),
        codebooks=jnp.asarray(np.asarray(g["codebooks"])),
        R=None if "R" not in g else jnp.asarray(np.asarray(g["R"])),
        h=int(g.attrs["h"]),
        train_codes=None if tc is None else jnp.asarray(
            np.asarray(tc).astype(np.int32)))


def load_model(path: str) -> MCQModel:
    import h5py
    with h5py.File(path, "r") as f:
        return _read_model(f["model"])


def save_index(path: str, index: MCQIndex) -> None:
    """Persist a searchable index: the model, the base codes and the
    norms byte — everything EXCEPT the scan structures, which
    `load_index` rebuilds on device (cheap next to the encode they
    encapsulate; base encoding at the reference's ilsiter=32 budget is
    the expensive artifact being saved)."""
    import h5py
    with h5py.File(path, "w") as f:
        g = f.create_group("model")
        _write_model(g, index.model)
        _put(f, "codes", _codes_np(index.codes, index.model.h))
        _put(f, "norms_codebook", index.norms_codebook)
        if index.norm_codes is not None:
            _put(f, "norm_codes", _codes_np(index.norm_codes, 256))
        f.attrs["mode"] = index.mode
        d = (index.scan_index.Xd.shape[1] if index.mode == "decoded"
             else index.scan_index.d)
        f.attrs["d"] = int(d)


def load_index(path: str, mode: str | None = None) -> MCQIndex:
    """Rebuild a saved index. ``mode`` overrides the saved layout
    (e.g. load a "decoded"-saved index as "codes" on a smaller card)."""
    import h5py

    from rayuela_tpu.search.codes import build_codes_index
    from rayuela_tpu.search.linscan import build_index

    with h5py.File(path, "r") as f:
        model = _read_model(f["model"])
        B = jnp.asarray(np.asarray(f["codes"]).astype(np.int32))
        norms_cb = (None if "norms_codebook" not in f else
                    jnp.asarray(np.asarray(f["norms_codebook"])))
        norm_codes = (None if "norm_codes" not in f else
                      jnp.asarray(np.asarray(f["norm_codes"])
                                  .astype(np.int32)))
        mode = str(f.attrs["mode"]) if mode is None else mode
        d = int(f.attrs["d"])
    if mode == "codes":
        if norms_cb is not None and norms_cb.size > model.h:
            # layout override from a decoded save: its 256-entry norms
            # codebook cannot ride an (h < 256)-row LUT stack —
            # re-derive an h-entry one from the saved base codes
            from rayuela_tpu.search.norms import (get_norms_codebook,
                                                  quantize_norms)
            _, norms_cb = get_norms_codebook(
                jax.random.PRNGKey(3), model.codebooks, B, h=model.h)
            norm_codes, _ = quantize_norms(model.codebooks, B, norms_cb)
        idx = build_codes_index(model.codebooks, B, pq=model.pq_layout,
                                d=d, norms_cbook=norms_cb,
                                norms_codes=norm_codes)
    else:
        nt = (None if norms_cb is None else
              jnp.take(norms_cb, norm_codes))
        idx = build_index(model.codebooks, B, pq=model.pq_layout, d=d,
                          norm_term=nt)
    return MCQIndex(model, B, idx, norms_cb, norm_codes, mode=mode)
