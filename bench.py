"""Headline benchmarks: SIFT1M-protocol scan + encode on one GPU.

    python bench.py

The first line printed is the card (``nvidia-smi`` name and power
limit); then one JSON line per metric: ``{"metric", "value", "unit",
"vs_baseline", "spread"}``. ``spread`` is max/min wall-clock over the
timing reps. Ratio metrics interleave the two implementations rep by
rep so drift affects both. Fails (nonzero exit) when JAX finds no GPU
or when any row fails.

* ``adc_scan_qps_sift1m_m8_knn1000`` / ``..._knn100`` — the deployment
  hot path (reference `src/Linscan.jl:5-26` →
  `deps/src/linscan_aqd.cpp:37-102`): n=1e6 base, m=8, h=256, d=128,
  nquery=1e4 — the SIFT1M 64-bit protocol of
  `demos/demos_train_query_base.jl:15-19`. `linscan.search` over the
  decoded index: scan kernel + exact repair of flagged queries.
  vs_baseline divides by a documented ~2,000 qps estimate of the
  reference's 16-core OpenMP scan (no number is published in-repo).
* ``codes_scan_qps_sift1m_m{8,16}_knn{1000,100}`` — same protocol on
  the code-resident index (`codes.search_codes`): 8/16 MB of packed
  codes on the device instead of a 256 MB decode.
* ``sharded_scan_qps_1dev_knn1000`` — the decoded search through the
  `parallel.mesh` wrapper on a one-device mesh; vs_baseline is the
  interleaved ratio to the direct `linscan.search`.
* ``icm_encode_vps_m8`` / ``_m16`` — LSQ-family ILS/ICM encode
  (ilsiter=8, icmiter=4, npert=4; reference
  `demos/demos_train_query_base.jl:64-67`) in vectors/s, running-sum
  form; vs_baseline is the interleaved speedup over the table form.
* ``viterbi_encode_vps_m8`` — ChainQ exact Viterbi encode (reference
  `deps/src/encode_icm.cpp:63-152`, `cudautils.cu:198-291`);
  vs_baseline 1.0 (the batched XLA path is the only one).
* ``codes_scan_qps_100m_m8_knn1000`` / ``codes_scan_qps_1b_m8_knn100``
  — n=1e8 / 1e9 random codes (0.8 / 8 GB packed) resident on one
  card; vs_baseline scales the reference estimate by base size.
* ``codes_scan_qps_streamed_2e8_knn100`` — n=2e8 packed codes in HOST
  memory streamed in two shards through `search_codes_streamed`
  (reference ``nsplits``, `src/LSQ_GPU.jl:218-264`); host->device
  transfer included.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SCAN_BASELINE_QPS = 2000.0  # documented estimate; see module docstring

N, D, M, H = 1_000_000, 128, 8, 256
NQ, KNN = 10_000, 1000
N_ENC = 200_000


def _block(x):
    import jax
    return jax.block_until_ready(x)


def _timed(fn, reps: int = 3) -> tuple[float, float]:
    """(best, spread=max/min) wall-clock over ``reps`` blocking calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), max(ts) / min(ts)


def _timed_interleaved(fn_a, fn_b, reps: int = 3):
    """Interleave two implementations rep by rep → (best_a, best_b,
    spread_a)."""
    ta, tb = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn_a())
        ta.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _block(fn_b())
        tb.append(time.perf_counter() - t0)
    return min(ta), min(tb), max(ta) / min(ta)


def emit(metric, value, unit, vs, spread=None):
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs}
    if spread is not None:
        rec["spread"] = spread
    print(json.dumps(rec), flush=True)


def bench_scan(C, B, Q):
    from rayuela_tpu.search.linscan import build_index, search

    index = build_index(C, B, pq=True, d=D)
    for knn, name in ((KNN, "adc_scan_qps_sift1m_m8_knn1000"),
                      (100, "adc_scan_qps_sift1m_m8_knn100")):
        _block(search(index, Q, knn))                 # compile/warm
        dt, spread = _timed(lambda knn=knn: search(index, Q, knn))
        qps = NQ / dt
        emit(name, qps, "queries/s", qps / SCAN_BASELINE_QPS, spread)
    return index


def bench_sharded(jax, index, Q):
    from rayuela_tpu.parallel.mesh import make_mesh, sharded_search
    from rayuela_tpu.search.linscan import search

    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    _block(sharded_search(mesh, index.Xd, index.x2, Q, k=KNN))
    t_sh, t_dir, spread = _timed_interleaved(
        lambda: sharded_search(mesh, index.Xd, index.x2, Q, k=KNN),
        lambda: search(index, Q, KNN))
    emit("sharded_scan_qps_1dev_knn1000", NQ / t_sh, "queries/s",
         t_dir / t_sh, spread)


def bench_scan_codes(jnp, rng, C, B, Q, m: int):
    from rayuela_tpu.search.codes import build_codes_index, search_codes

    if m != M:
        C = jnp.asarray(rng.standard_normal((m, H, D // m)), jnp.float32)
        B = jnp.asarray(rng.integers(0, H, size=(N, m)), jnp.int32)
    idx = build_codes_index(C, B, pq=True, d=D)
    for knn in (KNN, 100):
        _block(search_codes(idx, Q, knn))             # compile/warm
        dt, spread = _timed(lambda knn=knn: search_codes(idx, Q, knn))
        qps = NQ / dt
        emit(f"codes_scan_qps_sift1m_m{m}_knn{knn}", qps, "queries/s",
             qps / SCAN_BASELINE_QPS, spread)


def bench_encode(jax, jnp, rng):
    from rayuela_tpu.ops.icm import encoding_icm

    key = jax.random.PRNGKey(0)
    X = jnp.asarray(rng.standard_normal((N_ENC, D)), jnp.float32)
    kw = dict(ilsiter=8, icmiter=4, npert=4, randord=True)
    for m in (8, 16):
        C = jnp.asarray(rng.standard_normal((m, H, D)) * 0.2, jnp.float32)
        B0 = jnp.asarray(rng.integers(0, H, size=(N_ENC, m)), jnp.int32)

        def run(form, C=C, B0=B0):
            return encoding_icm(key, X, C, B0, form=form, **kw)

        _block(run("running"))
        _block(run("table"))
        t_r, t_t, spread = _timed_interleaved(lambda: run("running"),
                                              lambda: run("table"))
        emit(f"icm_encode_vps_m{m}", N_ENC / t_r, "vectors/s", t_t / t_r,
             spread)


def bench_viterbi(jnp, rng):
    from rayuela_tpu.ops.viterbi import viterbi_encode

    n_vit = 100_000
    X = jnp.asarray(rng.standard_normal((n_vit, D)), jnp.float32)
    C = jnp.asarray(rng.standard_normal((M, H, D)) * 0.2, jnp.float32)
    _block(viterbi_encode(X, C))
    dt, spread = _timed(lambda: viterbi_encode(X, C), reps=4)
    emit("viterbi_encode_vps_m8", n_vit / dt, "vectors/s", 1.0, spread)


def _random_packed_codes(jax, jnp, n_big: int, seed: int):
    """Random packed codes generated on the device: uniform random
    bytes are uniform random codes at h=256, and the packed (n, m/4)
    int32 layout is just those bytes."""
    bits = jax.random.bits(jax.random.PRNGKey(seed), (n_big, M // 4),
                           jnp.uint32)
    return _block(jax.lax.bitcast_convert_type(bits, jnp.int32))


def bench_scan_big(jax, jnp, C, Q, n_big: int, knn: int, name: str):
    from rayuela_tpu.search.codes import CodesIndex, search_codes

    nq_big = 1_000
    packed = _random_packed_codes(jax, jnp, n_big, seed=n_big % 997)
    idx = CodesIndex(packed, M, C, pq=True, d=D, norms_cbook=None)
    Qb = Q[:nq_big]
    _block(search_codes(idx, Qb, knn))
    dt, spread = _timed(lambda: search_codes(idx, Qb, knn), reps=2)
    qps = nq_big / dt
    emit(name, qps, "queries/s", qps / (SCAN_BASELINE_QPS * N / n_big),
         spread)


def bench_scan_streamed(rng, C, Q):
    from rayuela_tpu.search.codes import search_codes_streamed

    n_big, nq_big, knn, shard = 200_000_000, 1_000, 100, 100_000_000
    host_packed = rng.integers(-(1 << 31), 1 << 31, size=(n_big, M // 4),
                               dtype=np.int64).astype(np.int32)
    Qb = Q[:nq_big]

    def call():
        return search_codes_streamed(C, host_packed, Qb, knn, pq=True,
                                     d=D, mprime=M, shard_n=shard)[0]

    _block(call())                                    # compile/warm
    dt, spread = _timed(call, reps=2)
    qps = nq_big / dt
    emit("codes_scan_qps_streamed_2e8_knn100", qps, "queries/s",
         qps / (SCAN_BASELINE_QPS * N / n_big), spread)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    from rayuela_tpu import platform
    from rayuela_tpu.utils import enable_compile_cache

    if platform.backend() != "gpu":
        print("bench.py needs a GPU; JAX found none", file=sys.stderr)
        return 2
    print(f"# card: {card()}", flush=True)
    enable_compile_cache()

    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    C = jnp.asarray(rng.standard_normal((M, H, D // M)), jnp.float32)
    B = jnp.asarray(rng.integers(0, H, size=(N, M)), jnp.int32)
    Q = jnp.asarray(rng.standard_normal((NQ, D)), jnp.float32)

    index = bench_scan(C, B, Q)
    bench_sharded(jax, index, Q)
    del index
    bench_scan_codes(jnp, rng, C, B, Q, 8)
    bench_scan_big(jax, jnp, C, Q, 100_000_000, KNN,
                   "codes_scan_qps_100m_m8_knn1000")
    bench_scan_codes(jnp, rng, C, B, Q, 16)
    bench_encode(jax, jnp, rng)
    bench_viterbi(jnp, rng)
    bench_scan_big(jax, jnp, C, Q, 1_000_000_000, 100,
                   "codes_scan_qps_1b_m8_knn100")
    bench_scan_streamed(rng, C, Q)
    return 0


if __name__ == "__main__":
    sys.exit(main())
