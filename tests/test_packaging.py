"""Release-surface checks: version consistency, public `__all__`
exports resolve, console entry point imports, doc numbers not drifted
(installability + doc drift as CI failures)."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_version_single_sourced():
    import rayuela_tpu
    pyproject = (ROOT / "pyproject.toml").read_text()
    mo = re.search(r'^version = "([^"]+)"', pyproject, re.M)
    assert mo, "pyproject.toml has no version"
    assert rayuela_tpu.__version__ == mo.group(1)


def test_public_all_exports_resolve():
    import rayuela_tpu
    for name in rayuela_tpu.__all__:
        assert getattr(rayuela_tpu, name, None) is not None or \
            importlib.import_module(f"rayuela_tpu.{name}")
    for sub in ("experiments", "io", "models", "ops", "parallel",
                "search"):
        mod = importlib.import_module(f"rayuela_tpu.{sub}")
        assert mod.__all__, f"{sub} has no __all__"
        for name in mod.__all__:
            assert hasattr(mod, name), f"{sub}.{name} missing"


def test_console_entry_point_importable():
    from rayuela_tpu.cli import main
    assert callable(main)


def test_pyproject_script_target_matches_cli():
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert 'rayuela-demo = "rayuela_tpu.cli:main"' in pyproject


def test_doc_drift_check_passes():
    """README/docs throughput numbers must match PERF.md's headline
    table (stale docs as a test failure)."""
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_doc_drift.py")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_graft_entry_forces_cpu_devices_without_env():
    """`dryrun_multichip` must not depend on env vars: where jax is
    imported before user code, `JAX_PLATFORMS=cpu` and the XLA
    device-count flag come too late. `ensure_cpu_devices` must yield
    >= n virtual CPU devices from a CLEAN environment."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                        "RAYUELA_DRYRUN_REAL")}
    code = (
        "import sys; sys.path.insert(0, %r); "
        "from __graft_entry__ import ensure_cpu_devices; "
        "ensure_cpu_devices(8); import jax; "
        "devs = jax.devices(); "
        "assert len(devs) >= 8, devs; "
        "assert devs[0].platform == 'cpu', devs; "
        "print('cpu8 ok')" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "cpu8 ok" in out.stdout
