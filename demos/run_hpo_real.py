"""Run the GP-surrogate HPO for real: budget ~20 full
train->encode->search evaluations on synthetic-corr-small (64- or
128-bit codes), record the incumbent and its recall delta vs the
default config.

Reference anchor: `smac/configure.py:100-110` (SMAC
over the same space, minimizing 1 - recall@1). The reference's own
recorded incumbents diverge most from the defaults at m=16
(`smac/test_lsq.jl:208-226`), which is why the 128-bit campaign
matters.

    python demos/run_hpo_real.py hpo16.log 16 20
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOG = sys.argv[1] if len(sys.argv) > 1 else "hpo_real.log"
M_ARG = int(sys.argv[2]) if len(sys.argv) > 2 else 8
BUDGET = int(sys.argv[3]) if len(sys.argv) > 3 else 20
_log = open(LOG, "w")


def log(*a):
    print(*a, file=_log, flush=True)
    print(*a, flush=True)


def main():
    import jax

    from rayuela_tpu.utils import enable_compile_cache

    enable_compile_cache()

    from rayuela_tpu.experiments.datasets import read_dataset
    from rayuela_tpu.experiments.hpo import (LSQConfig, default_objective,
                                             optimize_smac)

    log("devices:", jax.devices())
    ds = read_dataset("synthetic-corr-small")
    # M_ARG = codebook count
    m, h, niter = M_ARG, 256, 5
    log(f"space: m={m} codebooks, budget={BUDGET}")
    obj = default_objective(ds, m, h, niter)

    t0 = time.time()
    default_cfg = LSQConfig()
    default_loss = obj(default_cfg)
    log(f"default {default_cfg}: loss={default_loss:.4f} "
        f"(recall@1={1 - default_loss:.4f}) [{time.time() - t0:.0f}s]")

    t0 = time.time()
    best_cfg, best_loss, hist = optimize_smac(obj, m, budget=BUDGET,
                                              seed=0)
    log(f"incumbent {best_cfg}: loss={best_loss:.4f} "
        f"(recall@1={1 - best_loss:.4f})")
    log(f"delta vs default: {default_loss - best_loss:+.4f} recall@1 "
        f"({time.time() - t0:.0f}s for 20 evals)")
    log("history best-so-far:",
        [round(min(l for _, l in hist[:i + 1]), 4)
         for i in range(len(hist))])
    log("DONE")


if __name__ == "__main__":
    main()
