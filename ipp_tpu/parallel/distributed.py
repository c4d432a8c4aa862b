"""Multi-host wiring — jax.distributed in place of the reference's MPI.

The reference scales across nodes with mpi4py master-worker wrappers
(TeraStitcher/pyscripts/Parastitcher.py:410-470, paraconverter.py) and
shared-filesystem claim files (LsDeconv.m:697-706).  The JAX equivalent
is single-controller: every host runs the same program,
`jax.distributed.initialize` wires the coordinator, meshes span all
global devices, and XLA collectives ride NVLink within a host and the
network between hosts.

Helpers here keep the pipelines host-count agnostic:
- `initialize()` — env-driven jax.distributed.initialize (no-op when
  single-process or already initialized);
- `global_mesh()` — ('data', 'z') mesh over ALL global devices;
- `device_put_global(array, sharding)` — on one host this is
  jax.device_put; across hosts each process contributes the shard rows
  its addressable devices own via make_array_from_process_local_data;
- `process_slice(n)` — which of n work items this process feeds (block
  reading is divided by process, replacing MPI rank partitioning).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np

__all__ = ["initialize", "global_mesh", "device_put_global",
           "process_slice", "is_multihost"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Wire up jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    supported cluster environment).  Returns True if a multi-process
    runtime is active afterwards.  Safe to call more than once."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    # NEVER touch the backend (jax.process_count / jax.devices) before
    # jax.distributed.initialize: backend init pins process_count at 1 and
    # makes the later initialize a silent no-op.  Probe the distributed
    # client state instead.
    already = False
    try:
        already = bool(jax.distributed.is_initialized())
    except AttributeError:  # pragma: no cover - older JAX
        from jax._src import distributed as _dist

        already = _dist.global_state.client is not None
    if already:
        return jax.process_count() > 1
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single-process run: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax.process_count() > 1


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh(z_parallel: int = 1):
    """('data', 'z') mesh over all global devices (multi-host aware)."""
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    assert n % z_parallel == 0, (n, z_parallel)
    return Mesh(devices.reshape(n // z_parallel, z_parallel),
                ("data", "z"))


def device_put_global(array: np.ndarray, sharding):
    """Place a host array onto a (possibly multi-host) sharding.

    Single-process: jax.device_put.  Multi-process: every process passes
    the SAME logical array view restricted to its local shard rows;
    jax.make_array_from_process_local_data assembles the global Array."""
    if jax.process_count() == 1:
        return jax.device_put(array, sharding)
    return jax.make_array_from_process_local_data(sharding, array)


def process_slice(n_items: int) -> Tuple[int, int]:
    """[start, stop) of the work items this process is responsible for
    reading/writing (contiguous split, remainder to the first ranks) —
    the role of Parastitcher's rank partitioning (:136-205)."""
    p = jax.process_count()
    r = jax.process_index()
    base, extra = divmod(n_items, p)
    start = r * base + min(r, extra)
    stop = start + base + (1 if r < extra else 0)
    return start, stop
