"""Device-mesh construction and sharding helpers.

Replaces the reference's process pools / MPI ranks / GPU semaphores
(SURVEY §2.3) with a jax.sharding.Mesh: tiles and blocks are data-parallel
over the 'data' axis; large single blocks shard their z axis over 'z'
(the sequence-parallel analog — SURVEY §5 long-context mapping).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "default_mesh", "data_sharding", "block_sharding",
           "P"]


def make_mesh(n_devices: Optional[int] = None,
              z_parallel: int = 1) -> Mesh:
    """Mesh with axes ('data', 'z'): data-parallel over blocks/tiles, with
    optional intra-block z sharding."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    assert n % z_parallel == 0, (n, z_parallel)
    arr = np.array(devices).reshape(n // z_parallel, z_parallel)
    return Mesh(arr, ("data", "z"))


def default_mesh():
    """(mesh_or_None, plane_batch): the pipelines' shared policy — a
    ('data', 'z'=1) mesh when more than one device is visible, else no
    mesh with a 4-plane dispatch batch (amortizes per-dispatch overhead
    on a single device).  One home so process_images, tsv_tools
    and future callers cannot drift apart."""
    if len(jax.devices()) > 1:
        return make_mesh(), 1
    return None, 4


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) axis over 'data', replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def block_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard (batch, z, y, x): batch over 'data', z over 'z'."""
    spec = ["data", "z"] + [None] * (ndim - 2)
    return NamedSharding(mesh, P(*spec))


def shard_map_unchecked(f, mesh, in_specs, out_specs):
    """`jax.shard_map` with varying-mesh-axes checking off: the shard_maps
    here run per-device programs (data-parallel batches, z-halo RL) whose
    RL `while_loop` carries mix varying and unvarying values, which the
    check would reject."""
    import jax

    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
