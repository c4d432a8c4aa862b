"""Halo exchange over the device mesh.

The deconvolution block decomposition needs PSF-half halos of *real
neighbor data* (reference LsDeconv load_block symmetric/real padding,
LsDeconv.m:817-898).  When a volume's z axis is sharded over mesh axis 'z'
(sequence-parallel blocks), the halos live on neighbor devices; this module
exchanges them with `jax.lax.ppermute` inside `shard_map` — the ICI
collective replacing the reference's shared-filesystem overlap reads
(SURVEY §5 long-context mapping).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["exchange_halos_z", "sharded_map_blocks_z"]


def exchange_halos_z(local: jnp.ndarray, halo: int, axis_name: str = "z"):
    """Inside shard_map: return the local (D, H, W) block extended with
    `halo` planes of real data from the z-neighbors (edge devices replicate
    their own boundary plane, matching the reference's edge handling)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top = local[:halo]           # first planes -> previous device's bottom halo
    bottom = local[-halo:]       # last planes -> next device's top halo
    # receive from the previous device (its bottom) and the next (its top)
    from_prev = jax.lax.ppermute(
        bottom, axis_name, [(i, (i + 1) % n) for i in range(n)])
    from_next = jax.lax.ppermute(
        top, axis_name, [(i, (i - 1) % n) for i in range(n)])
    # edges: replicate own boundary instead of the wrapped-around data
    edge_top = jnp.broadcast_to(local[:1], (halo,) + local.shape[1:])
    edge_bottom = jnp.broadcast_to(local[-1:], (halo,) + local.shape[1:])
    up = jnp.where(idx == 0, edge_top, from_prev)
    down = jnp.where(idx == n - 1, edge_bottom, from_next)
    return jnp.concatenate([up, local, down], axis=0)


def sharded_map_blocks_z(fn, mesh: Mesh, halo: int, axis_name: str = "z"):
    """Wrap fn(block_with_halos) -> block into a z-sharded executable:
    each device processes its z slab extended by exchanged halos, and the
    halo region is cropped from the result.

    fn sees (local_z + 2*halo, H, W) and must return the same shape; the
    wrapper returns the cropped (local_z, H, W) pieces reassembled as a
    global (Z, H, W) array sharded over `axis_name`.
    """

    def local_fn(block):
        ext = exchange_halos_z(block, halo, axis_name)
        out = fn(ext)
        return out[halo:out.shape[0] - halo]

    from .mesh import shard_map_unchecked

    return shard_map_unchecked(local_fn, mesh=mesh,
                               in_specs=P(axis_name, None, None),
                               out_specs=P(axis_name, None, None))
