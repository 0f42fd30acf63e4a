#!/usr/bin/env python
"""query=base protocol at the reference's ntrials=10
(`demos/demos_query_base.jl:15`).

This runs the full 10-trial protocol on both reference shapes
(LabelMe22K: n=20019 base==train, nq=2000; MNIST: n=60000, nq=10000)
on synthetic-corr data with exact ground truth, and reports mean±std
+ the method ordering.

Usage: python demos/bench_query_base10.py [labelme|mnist] [ntrials]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from rayuela_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

SHAPES = {
    # reference demos/demos_query_base.jl:17-24
    "labelme": dict(ntrain=20019, nquery=2000),
    "mnist": dict(ntrain=60000, nquery=10000),
}


def main():
    shape = sys.argv[1] if len(sys.argv) > 1 else "labelme"
    ntrials = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    cfg = SHAPES[shape]
    from rayuela_tpu.experiments.datasets import make_synthetic
    from rayuela_tpu.experiments.drivers import run_query_base

    # queries perturb Xb rows, which run_query_base discards in favor
    # of Xt as the searched base — so queries are cluster draws NOT
    # present in the searched set (the hard regime)
    ds = make_synthetic(d=128, ntrain=cfg["ntrain"], nbase=4096,
                        nquery=cfg["nquery"], ncenters=64, seed=7,
                        corr=True, name=f"synthetic-corr-qb-{shape}")
    t0 = time.time()
    res = run_query_base(ds, m=8, h=256, niter=10, ntrials=ntrials,
                         knn=1000,
                         results_dir=f"qb10_{shape}_results",
                         verbose=True, seed=0)
    wall = time.time() - t0

    rows = {}
    for method, outs in res.items():
        r1 = np.array([float(o["recall"][0]) for o in outs])
        rows[method] = dict(mean=float(r1.mean()),
                            std=float(r1.std(ddof=1)) if len(r1) > 1
                            else 0.0,
                            trials=[float(v) for v in r1])
    order = sorted(rows, key=lambda m_: rows[m_]["mean"])
    print(f"\n=== {shape} shape, ntrials={ntrials}, "
          f"wall {wall:.0f}s ===")
    for m_ in order:
        r = rows[m_]
        print(f"{m_:8s} r@1 = {r['mean']:.4f} +- {r['std']:.4f}")
    print("ordering:", " < ".join(order))
    out = f"qb10_{shape}.json"
    with open(out, "w") as f:
        json.dump(dict(shape=shape, ntrials=ntrials, wall_s=wall,
                       rows=rows, ordering=order), f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
