#!/usr/bin/env python
"""Multi-card scaling benchmark: sharded SR training step + sharded
ADC scan at 1..N devices, reporting per-card efficiency.

On a multi-card host this measures scaling; on the CPU it runs against
virtual devices (--force-cpu-devices N) to validate the code path and
communication structure. The same `shard_map` programs run in both
cases — only the mesh differs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1 << 17,
                    help="training vectors")
    ap.add_argument("--nbase", type=int, default=1 << 18)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--force-cpu-devices", type=int, default=0)
    args = ap.parse_args()

    if args.force_cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{args.force_cpu_devices}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
        try:  # newer images ignore the XLA_FLAGS route (see conftest)
            jax.config.update("jax_num_cpu_devices",
                              args.force_cpu_devices)
        except Exception:
            pass
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rayuela_tpu.parallel.lsq_sharded import make_sr_train_step
    from rayuela_tpu.parallel.mesh import (make_mesh, shard_data,
                                           sharded_scan_topk)

    ndev_all = len(jax.devices())
    rng = np.random.default_rng(0)
    X = rng.standard_normal((args.n, args.d)).astype(np.float32)
    Xb_codes = rng.integers(0, args.h,
                            (args.nbase, args.m)).astype(np.int32)
    C = rng.standard_normal(
        (args.m, args.h, args.d)).astype(np.float32) * 0.3
    B = rng.integers(0, args.h, (args.n, args.m)).astype(np.int32)
    Q = rng.standard_normal((args.nq, args.d)).astype(np.float32)

    base = {}
    ndevs = [p for p in (1, 2, 4, 8, 16, 32) if p <= ndev_all]
    for p in ndevs:
        mesh = make_mesh(p, 1, devices=jax.devices()[:p])
        step = make_sr_train_step(mesh, h=args.h, niter=4, ilsiter=2,
                                  icmiter=2, npert=1, method="LSQ",
                                  chunk=2048, stats_chunk=8192)
        Xs = shard_data(mesh, jnp.asarray(X))
        Bs = shard_data(mesh, jnp.asarray(B))
        Cj = jnp.asarray(C)
        out = step(Xs, Bs, Cj, jnp.int32(0), jax.random.PRNGKey(0))
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = step(Xs, Bs, Cj, jnp.int32(1), jax.random.PRNGKey(1))
        jax.block_until_ready(out)
        t_train = time.perf_counter() - t0

        o = sharded_scan_topk(mesh, jnp.asarray(Q), Cj,
                              jnp.asarray(Xb_codes), k=args.k, tile=4096)
        jax.block_until_ready(o)
        t0 = time.perf_counter()
        o = sharded_scan_topk(mesh, jnp.asarray(Q), Cj,
                              jnp.asarray(Xb_codes), k=args.k, tile=4096)
        jax.block_until_ready(o)
        t_scan = time.perf_counter() - t0

        base.setdefault("train", t_train if p == 1 else base["train"])
        base.setdefault("scan", t_scan if p == 1 else base["scan"])
        eff_t = base["train"] / (t_train * p) * 100
        eff_s = base["scan"] / (t_scan * p) * 100
        print(f"devices={p:3d}  train {t_train*1e3:8.1f} ms "
              f"(eff {eff_t:5.1f}%)   scan {t_scan*1e3:8.1f} ms "
              f"(eff {eff_s:5.1f}%)")


if __name__ == "__main__":
    main()
