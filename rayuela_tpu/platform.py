"""The one place that decides which device the program runs on.

Every routing site (scan kernel vs XLA scan, bf16 vs f32 operands)
asks `backend()` instead of reading `jax.default_backend()` itself, so
there is exactly one answer per process and one list of supported
platforms:

* ``"gpu"`` — an NVIDIA card: the Pallas-Triton scan kernel
  (`rayuela_tpu.search.scan_kernel`) and bf16 operands where the
  module says so;
* ``"cpu"`` — tests and host-only runs: plain XLA everywhere, f32
  operands so results compare exactly against numpy references.

Any other backend raises: nothing in the package is written for it.
"""

from __future__ import annotations

import functools

import jax

SUPPORTED = ("gpu", "cpu")


@functools.cache
def backend() -> str:
    """``"gpu"`` or ``"cpu"``, read once from `jax.default_backend()`."""
    name = jax.default_backend()
    if name == "cuda":
        name = "gpu"
    if name not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}; rayuela_tpu runs on "
            f"{' or '.join(SUPPORTED)}")
    return name


def on_gpu() -> bool:
    return backend() == "gpu"


def operand_dtype():
    """Operand dtype for the bandwidth-bound matmuls (decoded index,
    ICM conditioning): bf16 on the GPU halves the bytes moved and runs
    on the tensor cores with f32 accumulation; f32 on the CPU keeps
    the tests' exact comparisons."""
    import jax.numpy as jnp
    return jnp.bfloat16 if on_gpu() else jnp.float32
