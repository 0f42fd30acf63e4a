"""The one platform decision (`rayuela_tpu.platform`), the compile-cache
helper, and the entry points that must refuse to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from rayuela_tpu import platform

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def fake_backend(monkeypatch):
    """Pretend JAX reports ``name``; the cached decision is reset
    before and after."""
    def use(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        platform.backend.cache_clear()
    yield use
    platform.backend.cache_clear()


@pytest.mark.parametrize("name,want", [("cpu", "cpu"), ("gpu", "gpu"),
                                       ("cuda", "gpu")])
def test_backend_choice(fake_backend, name, want):
    fake_backend(name)
    assert platform.backend() == want
    assert platform.on_gpu() == (want == "gpu")


@pytest.mark.parametrize("name", ["neuron", "rocm", "METAL"])
def test_backend_rejects_unsupported(fake_backend, name):
    fake_backend(name)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.backend()


@pytest.mark.parametrize("name,dtype", [("cpu", jnp.float32),
                                        ("gpu", jnp.bfloat16)])
def test_operand_dtype_per_backend(fake_backend, name, dtype):
    fake_backend(name)
    assert platform.operand_dtype() == dtype


def test_backend_is_read_once(fake_backend, monkeypatch):
    fake_backend("cpu")
    assert platform.backend() == "cpu"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.backend() == "cpu"          # cached decision


def test_routes_follow_platform(fake_backend, rng):
    """The ICM table dtype and the decoded index dtype both come from
    the platform module."""
    from rayuela_tpu.ops.icm import _table_dtype
    from rayuela_tpu.search.linscan import build_index
    C = jnp.asarray(rng.standard_normal((2, 4, 8)), jnp.float32)
    B = jnp.zeros((10, 2), jnp.int32)
    fake_backend("gpu")
    assert _table_dtype() == jnp.bfloat16
    assert build_index(C, B).Xd.dtype == jnp.bfloat16
    fake_backend("cpu")
    assert _table_dtype() == jnp.float32
    assert build_index(C, B).Xd.dtype == jnp.float32


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from rayuela_tpu.utils import enable_compile_cache
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: seen.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert seen == []                         # nothing set in code


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from rayuela_tpu.utils import enable_compile_cache
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: seen.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert seen == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "tools/bench_kernels.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    r = _run([str(ROOT / script)], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script cannot pass."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
