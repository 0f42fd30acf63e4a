"""1-device-mesh full-train bench: the complete staged SR-D pipeline
(OPQ -> ChainQ -> SR-D) through `api.train(..., mesh=)` on one card
with a 1-device mesh, A/B'd in the same run against the meshless path
— the single-card anchor for multi-card scaling.

Reference anchor: the reference makes distribution ambient via
`addprocs` + Distributed workers (`src/Rayuela.jl:10,31`); here the
facade's `mesh=` kwarg is the equivalent switch.

    python demos/bench_mesh_train.py mtrain.log
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOG = sys.argv[1] if len(sys.argv) > 1 else "mtrain.log"
_log = open(LOG, "w")


def log(*a):
    print(*a, file=_log, flush=True)
    print(*a, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rayuela_tpu import api
    from rayuela_tpu.parallel.mesh import make_mesh
    from rayuela_tpu.utils import enable_compile_cache

    enable_compile_cache()

    log("devices:", jax.devices())
    n, d, m, h, niter = 100_000, 128, 8, 256, 5
    rng = np.random.default_rng(0)
    # anisotropic clusters (the synthetic-corr regime)
    cent = rng.standard_normal((256, d)).astype(np.float32) * 2.0
    X = (cent[rng.integers(0, 256, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    Xj = jnp.asarray(X)
    _ = np.asarray(Xj[0, :1])
    mesh = make_mesh(1)
    log(f"mesh: {mesh}")

    walls = {}
    for rep in range(2):            # rep 0 = compile, rep 1 = steady
        for tag, kw in (("meshless", {}), ("mesh1", {"mesh": mesh})):
            t0 = time.perf_counter()
            model = api.train(Xj, "sr_d", m, h, niter=niter,
                              key=jax.random.PRNGKey(rep), **kw)
            _ = np.asarray(model.codebooks[0, :1, :1])
            dt = time.perf_counter() - t0
            walls.setdefault(tag, []).append(dt)
            from rayuela_tpu.ops.qerror import qerror
            err = float(qerror(Xj, model.codebooks, model.train_codes))
            log(f"{tag} rep{rep}: {dt:.1f}s "
                f"({n * niter / dt:.0f} vec-iters/s) train qerror {err:.4f}")
    r = walls["mesh1"][-1] / walls["meshless"][-1]
    log(f"steady-state mesh1/meshless wall ratio: {r:.3f} "
        f"(overhead {100 * (r - 1):+.1f}%)")
    log("DONE")


if __name__ == "__main__":
    main()
