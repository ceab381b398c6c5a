"""Two-level composition: replicas over one mesh axis, space over the other
(SURVEY §2 last bullet).

On a plain 2-axis mesh ("slice", "space") — for example two pairs of cards
— the MD decomposition splits the two kinds of parallelism:

* **along "space"**: one replica's spatial work — the slab/halo direct
  space, psum of structure factors / partial PME grids, force assembly
  (parallel.halo / parallel.shard);
* **along "slice"**: replica ensembles.  Replicas are independent
  trajectories, so the per-step traffic along this axis is ZERO; only
  ensemble observables (mean energy, order parameters, replica-exchange
  swaps) cross it, and only when sampled.

``make_multislice_energy_fn`` builds that composition: the batch axis is
sharded over slices, each replica's work is sharded over its slice's
devices, and ``ensemble_mean`` shows the (off-path) cross-slice reduction.
When the two axes map to links of different speed (cards of one host vs
hosts), put "slice" on the slower one; the program is identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .halo import _halo_local_energy_builder, halo_compatible
from .shard import _local_energy_builder


def make_multislice_energy_fn(system, mesh: Mesh, slice_axis: str = "slice",
                              space_axis: str = "space"):
    """energy_batch(positions [R, N, 3]) -> [R]: replicas sharded over
    ``slice_axis`` (zero per-step collectives), each replica's work
    sharded over ``space_axis`` (halo exchange when the cell grid divides
    the axis, work sharding otherwise).  Differentiable."""
    ndev = mesh.shape[space_axis]
    if halo_compatible(system, ndev):
        halo_inner = _halo_local_energy_builder(system, space_axis, ndev)
        # replica ensembles run at the fixed creation-time box (NPT over
        # replicas goes through npt.npt_vmaps_over_replicas / the vmap
        # drivers, not this path)
        inner = lambda x: halo_inner(x, system.box)
    else:
        inner = _local_energy_builder(system, space_axis, ndev)

    def local_batch(positions_chunk):          # [R_local, N, 3]
        return jax.vmap(inner)(positions_chunk)

    sharded = jax.shard_map(local_batch, mesh=mesh,
                            in_specs=P(slice_axis), out_specs=P(slice_axis),
                            check_vma=False)
    return jax.jit(sharded)


def ensemble_mean(values: jax.Array, mesh: Mesh,
                  slice_axis: str = "slice") -> jax.Array:
    """Mean of a replica-sharded [R] observable — the only collective that
    crosses the slice axis, off the step critical path."""
    def local(v):
        s = jax.lax.psum(jnp.sum(v), slice_axis)
        return s / values.shape[0]

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(slice_axis), out_specs=P(),
        check_vma=False))(values)


def shard_batch(batch: jax.Array, mesh: Mesh, slice_axis: str = "slice"):
    """Place a [R, ...] replica batch with R sharded over the slice axis."""
    return jax.device_put(batch, NamedSharding(mesh, P(slice_axis)))
