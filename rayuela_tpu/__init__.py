"""rayuela_tpu — a multi-codebook quantization (MCQ) engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capability set of
Rayuela.jl (PQ, OPQ, RVQ, ERVQ, ChainQ, LSQ, LSQ++/SR, CQ interop;
ADC linear-scan search; recall evaluation; TEXMEX/HDF5 I/O) that runs
on NVIDIA GPUs: hot loops are matmuls and gathers that XLA compiles,
the search is one fused Pallas-Triton scan kernel, training statistics
are psum-able across a device mesh, and the base-set scan shards over
the data axis with an all-gather top-k merge. `rayuela_tpu.platform`
decides between the GPU and the CPU (tests).

Data model (row-major, 0-based — see `rayuela_tpu.utils`):
  X (n, d) f32 · C (m, h, d) or (m, h, d/m) f32 · B (n, m) int32.
"""

from rayuela_tpu import api, utils  # noqa: F401

__version__ = "1.0.0"          # keep in sync with pyproject.toml
                               # (tests/test_packaging.py enforces it)

__all__ = ["api", "experiments", "io", "models", "ops", "parallel",
           "search", "utils", "__version__"]
