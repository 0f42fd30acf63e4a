"""True multi-PROCESS integration test for `rayuela_tpu.parallel.launch`.

Everything else in the suite runs single-process on an 8-device CPU
mesh; this spawns TWO OS processes that bootstrap `jax.distributed`
(gloo CPU collectives), assemble a globally-sharded code array with
`host_local_to_global` (each process contributes only its own rows,
as one host of a cluster would after reading its slice of the base set),
and run the data-parallel `sharded_scan_topk` over the 2-process ×
2-device global mesh. The reference has no multi-machine story at all
(SURVEY.md §2.5 — Julia `Distributed` + SharedArrays, one host); this
is the multi-host plumbing it lacked.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["RAYUELA_REPO"])
    import numpy as np
    import jax
    # if jax was imported before this script ran, the env var alone
    # does not switch platforms — mirror tests/conftest.py.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from rayuela_tpu.parallel.launch import (global_mesh,
                                             host_local_to_global,
                                             initialize)
    from rayuela_tpu.parallel.mesh import sharded_scan_topk

    assert initialize() is True, "distributed bootstrap failed"
    assert jax.process_count() == 2, jax.process_count()
    pid = jax.process_index()

    mesh = global_mesh()                      # (data=4, model=1)
    assert mesh.devices.size == 4

    # Same seed everywhere: queries/codebooks replicated, codes global.
    rng = np.random.default_rng(7)
    n, m, h, d, nq, k = 4096, 4, 16, 32, 8, 10
    C = rng.standard_normal((m, h, d), dtype=np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng.standard_normal((nq, d), dtype=np.float32)

    # Each process contributes ONLY its half of the codes.
    B_local = B[pid * (n // 2): (pid + 1) * (n // 2)]
    Bg = host_local_to_global(mesh, B_local)
    assert Bg.shape == (n, m)

    dists, ids = sharded_scan_topk(mesh, Q, C, Bg, k=k)
    dists, ids = np.asarray(dists), np.asarray(ids)

    # Exact reference, recomputed locally from the shared seed.
    Xhat = C[np.arange(m), B].sum(axis=1)                 # (n, d)
    full = ((Q[:, None, :] - Xhat[None]) ** 2).sum(-1)    # (nq, n)
    ref_ids = np.argsort(full, axis=1, kind="stable")[:, :k]
    ref_d = np.take_along_axis(full, ref_ids, axis=1)
    np.testing.assert_allclose(dists, ref_d, rtol=2e-4, atol=2e-4)
    # ids may differ on exact distance ties only
    tie = np.isclose(ref_d, dists, rtol=2e-4)
    assert (ids == ref_ids)[tie].mean() > 0.99
    print(f"proc {pid}: multihost scan OK", flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_scan(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   RAYUELA_REPO=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))),
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(pid),
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid}: multihost scan OK" in out
