"""Multi-host (multi-process) bootstrap for GPU clusters.

The reference had no multi-machine story (Julia ``Distributed`` workers
on ONE host + threads, SURVEY.md §2.5); everything in
`rayuela_tpu.parallel` is written against a `jax.sharding.Mesh`, which
extends across processes transparently once `jax.distributed` is
initialized — the same `shard_map` training steps and sharded searches
then run with data sharded across hosts, XLA routing collectives
through NCCL (NVLink within a host, the network across hosts).

Usage: one process per host, each seeing all of its host's cards::

    from rayuela_tpu.parallel.launch import initialize, global_mesh
    initialize("host0:1234", num_processes=2, process_id=RANK)
    mesh = global_mesh(n_model=1)     # (data, model) over ALL processes

    # arrays created per-host: use host_local_to_global to assemble a
    # globally-sharded array from each host's local shard
    Xg = host_local_to_global(mesh, X_local)

Where several processes share a host, give each its own cards with
``local_device_ids`` — no two processes may open one card (each JAX
process reserves most of a card's memory when it starts).

Nothing detects a cluster automatically: the coordinator address,
process count and id come from the arguments or from the
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` env vars. Single-process runs are untouched:
`initialize()` is a no-op when no coordinator is configured, and
`global_mesh` falls back to the local devices.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None) -> bool:
    """Initialize `jax.distributed` when a multi-process launch is
    configured; returns True if distributed mode is active.

    Configuration sources, in order: explicit arguments; the standard
    env vars (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``). A plain single-process run (neither) is a
    no-op. ``local_device_ids`` restricts this process to those cards
    of its host (several processes per host)."""
    # NB: must not touch the XLA backend before jax.distributed
    # initializes (jax.process_count()/jax.devices() would), so probe
    # the distributed service state directly.
    if jax.distributed.is_initialized():
        return True                       # already initialized
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["JAX_NUM_PROCESSES"])
        if "JAX_NUM_PROCESSES" in os.environ else None)
    process_id = process_id if process_id is not None else (
        int(os.environ["JAX_PROCESS_ID"])
        if "JAX_PROCESS_ID" in os.environ else None)
    if coordinator_address is None and num_processes is None:
        return False                      # single-process run
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return True


def global_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ALL processes' devices (falls back
    to local devices in single-process mode) — drop-in for
    `rayuela_tpu.parallel.mesh.make_mesh` on multi-host runs."""
    devices = np.asarray(jax.devices())   # global across processes
    if n_data is None:
        n_data = devices.size // n_model
    devices = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(devices, ("data", "model"))


def host_local_to_global(mesh: Mesh, x_local, axis: int = 0) -> Array:
    """Assemble a globally-sharded array (sharded over ``data`` along
    ``axis``) from each host's LOCAL slice — the multi-host version of
    `mesh.shard_data`, built on `jax.make_array_from_process_local_data`.

    Each process passes its own rows (e.g. the slice of the base set it
    read from disk); no host ever materializes the full array."""
    spec = [None] * np.ndim(x_local)
    spec[axis] = "data"
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(jax.numpy.asarray(x_local), sharding)
    return jax.make_array_from_process_local_data(sharding, x_local)
