"""Time each translated kernel against its plain-XLA version on the card.

    python tools/bench_kernels.py [--what scan,icm,viterbi] [--n 1000000]
                                  [--nq 10000] [--check]

* scan — the Pallas-Triton scan kernel (`search.scan_kernel`) on a
  decoded index against `linscan.exact_rescan`, and on a packed-code
  index (in-kernel decode) against decode-tile-then-matmul
  (`linscan.scan_topk`) and the tiled XLA LUT scan
  (`codes._xla_lut_scan_tiled`), at d=128 (``--d``), h=256 (``--h``),
  m in {8, 16}, k in {100, 1000}, random PQ codes;
  plus the public routes end to end (`codes.search_codes`,
  `linscan.search`: kernel + exact repair of flagged queries);
* icm — the running-sum and table forms of the ICM encoder
  (`ops.icm.encoding_icm(form=...)`) at 2e5 vectors, ilsiter=8,
  icmiter=4, m in {8, 16};
* viterbi — `ops.viterbi.viterbi_encode` at 1e5 vectors, m=8.

Each line printed is one JSON record: the device (`device_kind`, the
card's name and power limit from nvidia-smi), the cold first call
(compile included) and the median warm wall time in ms. ``--check``
also compares each scan against its oracle on 256 queries. Fails
unless JAX's default backend is the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rayuela_tpu import platform  # noqa: E402
from rayuela_tpu.utils import enable_compile_cache  # noqa: E402


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def timed(fn, reps: int = 3) -> tuple[float, float]:
    """(cold ms incl. compile, median warm ms); blocks on the result."""
    t = time.perf_counter()
    jax.block_until_ready(fn())
    cold = (time.perf_counter() - t) * 1e3
    ws = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        ws.append((time.perf_counter() - t) * 1e3)
    return cold, float(np.median(ws))


def emit(**rec):
    rec.setdefault("device", jax.devices()[0].device_kind)
    print(json.dumps(rec), flush=True)


def bench_scan(n: int, nq: int, check: bool, ms=(8, 16), ks=(100, 1000),
               sweep: list[dict] | None = None, xla: bool = True,
               kinds=("codes", "decoded"), d: int = 128, h: int = 256):
    from rayuela_tpu.search import codes, linscan, scan_kernel

    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.standard_normal((nq, d)).astype(np.float32))
    for m in ms:
        C = jnp.asarray(rng.standard_normal((m, h, -(-d // m)))
                        .astype(np.float32))
        B = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
        idx = codes.build_codes_index(C, B, pq=True, d=d)
        Cf, nrm = idx.decode_operands(d, jnp.bfloat16)
        dec = (linscan.build_index(C, B, pq=True, d=d)
               if "decoded" in kinds else None)
        for k in ks:
            for cfg in (sweep or [{}]):
                p = scan_kernel.plan(nq, n, k, **cfg)

                def kc(cfg=cfg):
                    return scan_kernel.scan_topk_codes(
                        Q, idx.packed, Cf, nrm, k, pq=True, m=m, h=h,
                        **cfg)

                def kd(cfg=cfg):
                    return scan_kernel.scan_topk_decoded(
                        Q, dec.Xd, dec.x2, k, **cfg)

                for kind, fn in (("codes", kc), ("decoded", kd)):
                    if kind not in kinds:
                        continue
                    cold, warm = timed(fn)
                    fl = int(np.asarray(fn()[2]).sum())
                    emit(op=f"kernel_{kind}", m=m, k=k, n=n, nq=nq,
                         plan=p, cold_ms=cold, warm_ms=warm, flagged=fl)
            # end to end through the public routes: kernel + exact
            # repair of flagged queries + |q|^2
            if "codes" in kinds:
                cold, warm = timed(lambda: codes.search_codes(idx, Q, k))
                emit(op="e2e_search_codes", m=m, k=k, n=n, nq=nq,
                     cold_ms=cold, warm_ms=warm)
            if "decoded" in kinds:
                cold, warm = timed(lambda: linscan.search(dec, Q, k))
                emit(op="e2e_search_decoded", m=m, k=k, n=n, nq=nq,
                     cold_ms=cold, warm_ms=warm)
            if check:
                sub = Q[:256]
                s, i, _ = scan_kernel.scan_topk_codes(
                    sub, idx.packed, Cf, nrm, k, pq=True, m=m, h=h)
                so, io = codes._xla_lut_scan_tiled(idx, sub, k, d,
                                                   jnp.float32)
                emit(op="check_codes", m=m, k=k,
                     max_abs=float(jnp.max(jnp.abs(s - so))),
                     id_agree=float(jnp.mean(i == io)))
            if not xla:
                continue
            if dec is not None:
                cold, warm = timed(lambda: linscan.exact_rescan(
                    Q, dec.Xd, dec.x2, k), reps=1)
                emit(op="xla_exact_rescan", m=m, k=k, n=n, nq=nq,
                     cold_ms=cold, warm_ms=warm)
            cold, warm = timed(lambda: linscan.scan_topk(
                Q, C, B, k=k, pq=True), reps=1)
            emit(op="xla_decode_tile_matmul", m=m, k=k, n=n, nq=nq,
                 cold_ms=cold, warm_ms=warm)
            if n <= 10_000_000:
                cold, warm = timed(lambda: codes._xla_lut_scan_tiled(
                    idx, Q, k, d, jnp.float32), reps=1)
                emit(op="xla_lut_tiled", m=m, k=k, n=n, nq=nq,
                     cold_ms=cold, warm_ms=warm)


def bench_icm(n: int = 200_000, ms=(8, 16)):
    from rayuela_tpu.ops.icm import encoding_icm
    from rayuela_tpu.ops.qerror import veccost_chunked

    d, h = 128, 256
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    for m in ms:
        C = jnp.asarray(rng.standard_normal((m, h, d)).astype(np.float32)
                        * 0.3)
        B0 = jnp.asarray(rng.integers(0, h, (n, m)).astype(np.int32))
        key = jax.random.PRNGKey(0)
        for form in ("running", "table"):
            def fn(form=form):
                return encoding_icm(key, X, C, B0, ilsiter=8, icmiter=4,
                                    form=form)
            cold, warm = timed(fn, reps=2)
            e = float(jnp.mean(veccost_chunked(X, C, fn())))
            emit(op=f"icm_{form}", m=m, n=n, cold_ms=cold, warm_ms=warm,
                 vecs_per_s=n / warm * 1e3, mean_energy=e)


def bench_viterbi(n: int = 100_000, m: int = 8):
    from rayuela_tpu.ops.viterbi import viterbi_encode

    d, h = 128, 256
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    C = jnp.asarray(rng.standard_normal((m, h, d)).astype(np.float32)
                    * 0.3)
    cold, warm = timed(lambda: viterbi_encode(X, C))
    emit(op="viterbi_xla", m=m, n=n, cold_ms=cold, warm_ms=warm,
         vecs_per_s=n / warm * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="scan,icm,viterbi")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=10_000)
    ap.add_argument("--m", default="8,16")
    ap.add_argument("--k", default="100,1000")
    ap.add_argument("--sweep", default="",
                    help="JSON list of scan_kernel.plan overrides")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--no-xla", action="store_true",
                    help="skip the plain-XLA scans (kernel sweeps)")
    ap.add_argument("--kinds", default="codes,decoded",
                    help="any of codes,decoded")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--h", type=int, default=256)
    a = ap.parse_args(argv)
    if platform.backend() != "gpu":
        print("no GPU: JAX's default backend is "
              f"{platform.backend()!r}", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(f"# card: {card()}", flush=True)
    what = a.what.split(",")
    ms = tuple(int(x) for x in a.m.split(","))
    if "scan" in what:
        bench_scan(a.n, a.nq, a.check, ms=ms,
                   ks=tuple(int(x) for x in a.k.split(",")),
                   sweep=json.loads(a.sweep) if a.sweep else None,
                   xla=not a.no_xla, kinds=tuple(a.kinds.split(",")),
                   d=a.d, h=a.h)
    if "icm" in what:
        bench_icm(ms=ms)
    if "viterbi" in what:
        bench_viterbi()
    return 0


if __name__ == "__main__":
    sys.exit(main())
