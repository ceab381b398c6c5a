"""Spatial work-sharding over a JAX device mesh.

The reference is single-device: its only multi-GPU artifact is a vestigial
exclusion-tile range split (CudaCoulKernels.cpp:477-481, SURVEY §2).  This
module is the first-class replacement: the energy sum is *additive over
work items* (atom rows / cell rows / k-space structure-factor contributions /
exclusion pairs), so each device computes a chunk against replicated
positions and the total is assembled with ``psum``.

Design choices (scaling-book style):

* positions/charges are **replicated** (an [N,3] array is tiny even at 1M
  atoms); the O(N * neighbors) and O(N * K) *work* is what gets sharded.
  No halo exchange needed at this replication level; collectives are one
  psum of partial structure factors [KxKy, Kz] and the implicit psum of
  force partials in the backward pass.
* forces come from jax.grad *through* shard_map: the transpose of a
  replicated-in/replicated-out program psums per-device force partials
  automatically — the hand-written force reduction of a classical MD code
  falls out of AD.
* exclusions use the subtract route everywhere (compute all pairs, subtract
  excluded — the CUDA platform's contract, PBCForce.cu:753-815), which
  avoids data-dependent masks in the sharded hot loop.

Performance note: the spatial **halo** decomposition (halo.py, roll-based
walk, no gathers; 1-D x-slabs or 2-D x-by-y bricks, ``halo_decomp``) is
tried first and is the production scale-out path.  This module's cell-row
fallback uses gather-based ``cell_rows_direct_energy`` whose backward
lowers to scatter-adds — the pattern the single-chip roll walk exists to
avoid — so it is a correctness/coverage path only, and an expensive one.
With the 2-D decomposition
and ``create_system(halo_devices=D)`` grid sizing, essentially every
production (system, mesh) pair can stay on the halo path; landing here
means both grid axes are indivisible — rebuild the system with
``halo_devices`` set.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..cells import build_cell_list, cell_rows_direct_energy, half_shell_tables
from ..charges import effective_charges
from ..energy import _lj_pair_terms, dispersion_energy
from ..ewald import reciprocal_energy_from_sf, self_energy, structure_factors
from ..ops.erfc import erfc_fast
from ..pairs import displacement
from ..units import ONE_4PI_EPS0


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rows_pair_energy(x_rows, gi, positions, q_rows, q, system):
    """Energy of pairs (i in rows, j in all atoms) with global i<j ordering,
    *including* excluded pairs (subtract route).  gi: global row indices."""
    spec = system.spec
    n = positions.shape[0]
    d = displacement(x_rows[:, None, :], positions[None, :, :], system.box,
                     spec.pbc)
    r2 = jnp.sum(d * d, axis=-1)
    gj = jnp.arange(n)
    mask = (gi[:, None] < n) & (gi[:, None] < gj[None, :])
    if spec.pbc:
        mask = mask & (r2 < spec.cutoff * spec.cutoff)
    r2s = jnp.where(mask, r2, 1.0)
    inv_r = jax.lax.rsqrt(r2s)
    r = r2s * inv_r
    qq = q_rows[:, None] * q[None, :]
    if spec.pbc:
        coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(spec.alpha * r)
    else:
        coul = ONE_4PI_EPS0 * qq * inv_r
    half_sig = 0.5 * (system.sigma[gi % n][:, None] + system.sigma[None, :])
    eps = 4.0 * jnp.sqrt(system.epsilon[gi % n][:, None] * system.epsilon[None, :])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    return jnp.sum(jnp.where(mask, coul + lj, 0.0))


def _excl_chunk_energy(positions, q, system, e_start, e_chunk):
    """Exclusion corrections for a chunk of the exclusion list (subtract
    route): remove the short-range term the pair kernel added, and under PBC
    add the reciprocal-space correction -erf/r (unconditional, CPU
    semantics)."""
    spec = system.spec
    n_excl = system.n_exclusions
    if n_excl == 0:
        return jnp.zeros((), positions.dtype)
    # Pad the exclusion list so every device slices a full chunk.
    ids = e_start + jnp.arange(e_chunk)
    valid = ids < n_excl
    ids = jnp.where(valid, ids, 0)
    idx_i = system.exclusions[ids, 0]
    idx_j = system.exclusions[ids, 1]
    d = displacement(positions[idx_i], positions[idx_j], system.box, spec.pbc)
    r2 = jnp.sum(d * d, axis=-1)
    inv_r = jax.lax.rsqrt(r2)
    r = r2 * inv_r
    qq = q[idx_i] * q[idx_j]
    half_sig = 0.5 * (system.sigma[idx_i] + system.sigma[idx_j])
    eps = 4.0 * jnp.sqrt(system.epsilon[idx_i] * system.epsilon[idx_j])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    if spec.pbc:
        erfc_ar = erfc_fast(spec.alpha * r)
        in_cut = r < spec.cutoff
        e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)
        e = e - jnp.where(in_cut, ONE_4PI_EPS0 * qq * inv_r * erfc_ar + lj, 0.0)
    else:
        e = -(ONE_4PI_EPS0 * qq * inv_r + lj)
    return jnp.sum(jnp.where(valid, e, 0.0))


def make_sharded_energy_fn(system, mesh: Mesh, axis_name: str = "space"):
    """Build energy(positions) -> scalar with work sharded over
    ``mesh[axis_name]``; positions replicated, result replicated.

    Cell-route systems whose x cell-plane count divides the mesh axis take
    the spatial slab decomposition with ppermute halo exchange (halo.py:
    local binning, one boundary plane exchanged per neighbor); anything else
    falls back to work sharding over replicated positions (which keeps the
    full per-device rebuild and, on the cell route, gather-based rows —
    correct but slower at scale).

    Differentiable: jax.grad of the returned function yields forces with
    per-device partials psummed by the shard_map transpose.
    """
    from .halo import halo_compatible, make_halo_energy_fn

    if halo_compatible(system, mesh.shape[axis_name]):
        return make_halo_energy_fn(system, mesh, axis_name)
    local_energy = _local_energy_builder(system, axis_name,
                                         mesh.shape[axis_name])
    sharded = jax.shard_map(local_energy, mesh=mesh, in_specs=P(),
                            out_specs=P(), check_vma=False)
    return jax.jit(sharded)


def _local_energy_builder(system, axis_name: str, ndev: int):
    """Per-device energy program: replicated positions in, replicated scalar
    out, work chunked by lax.axis_index(axis_name) with psum assembly."""
    n = system.n_atoms
    spec = system.spec

    n_pad = _ceil_to(n, ndev)
    row_chunk = n_pad // ndev
    e_chunk = _ceil_to(max(system.n_exclusions, 1), ndev) // ndev

    # any cell-based single-chip method carries the cell metadata this
    # route needs (the dense-row fallback below is O(N^2/D))
    use_cells = spec.pbc and spec.direct_method.startswith("cell")
    if use_cells:
        gx, gy, gz = spec.cell_grid
        n_cells = gx * gy * gz
        c_pad = _ceil_to(n_cells, ndev)
        c_chunk = c_pad // ndev
        nbr_np, off_np = half_shell_tables(spec.cell_grid)
        # Pad row-side tables so every device slices a full chunk; padded
        # rows have sentinel-only slots and contribute nothing.
        nbr_np = np.concatenate(
            [nbr_np, np.zeros((c_pad - n_cells, 14), np.int32)], axis=0)
        off_np = np.concatenate(
            [off_np, np.zeros((c_pad - n_cells, 14, 3), np.int8)], axis=0)

    def local_energy(positions):
        dev = jax.lax.axis_index(axis_name)
        q = effective_charges(positions, system)  # replicated, cheap

        # --- direct space: chunk of work items per device
        if use_cells:
            slots, _ = build_cell_list(positions, system.box, spec.cell_grid,
                                       spec.cell_capacity)
            e_dir = cell_rows_direct_energy(positions, q, system, slots,
                                            jnp.asarray(nbr_np),
                                            jnp.asarray(off_np),
                                            dev * c_chunk, c_chunk)
        else:
            x_pad = jnp.concatenate(
                [positions, jnp.zeros((n_pad - n, 3), positions.dtype)], axis=0)
            q_pad = jnp.concatenate([q, jnp.zeros(n_pad - n, q.dtype)])
            gi = dev * row_chunk + jnp.arange(row_chunk)
            x_rows = jax.lax.dynamic_slice_in_dim(x_pad, dev * row_chunk,
                                                  row_chunk, axis=0)
            q_rows = jax.lax.dynamic_slice_in_dim(q_pad, dev * row_chunk,
                                                  row_chunk, axis=0)
            e_dir = _rows_pair_energy(x_rows, gi, positions, q_rows, q, system)

        e_excl = _excl_chunk_energy(positions, q, system, dev * e_chunk, e_chunk)

        if not spec.pbc:
            return jax.lax.psum(e_dir + e_excl, axis_name)

        # --- reciprocal: partial structure factors on an atom chunk, psum
        x_pad = jnp.concatenate(
            [positions, jnp.zeros((n_pad - n, 3), positions.dtype)], axis=0)
        q_pad = jnp.concatenate([q, jnp.zeros(n_pad - n, q.dtype)])
        xs = jax.lax.dynamic_slice_in_dim(x_pad, dev * row_chunk, row_chunk, 0)
        qs = jax.lax.dynamic_slice_in_dim(q_pad, dev * row_chunk, row_chunk, 0)
        sc_part, ss_part = structure_factors(xs, qs, system.box, spec.kmax)
        sc = jax.lax.psum(sc_part, axis_name)
        ss = jax.lax.psum(ss_part, axis_name)
        e_rec = reciprocal_energy_from_sf(sc, ss, system.box, spec.alpha,
                                          spec.kmax)
        e_self = self_energy(qs, spec.alpha)
        if spec.tail_coeff is not None:
            # replicated (outside the psum), like e_rec — added once
            e_rec = e_rec + dispersion_energy(system.box, spec,
                                              positions.dtype)
        return e_rec + jax.lax.psum(e_dir + e_excl + e_self, axis_name)

    return local_energy


def make_sharded_energy_and_forces_fn(system, mesh: Mesh,
                                      axis_name: str = "space"):
    """(positions) -> (energy, forces), both replicated, work sharded."""
    e_fn = make_sharded_energy_fn(system, mesh, axis_name)

    def ef(positions):
        e, g = jax.value_and_grad(e_fn)(positions)
        return e, -g

    return jax.jit(ef)


def make_replica_sharded_energy_fn(system, mesh: Mesh,
                                   replica_axis: str = "replica",
                                   space_axis: str = "space"):
    """2D-mesh engine: replicas data-parallel over ``replica_axis``, each
    replica's work sharded over ``space_axis``.

    Returns energy_batch(positions [R, N, 3]) -> [R], with R divisible by
    mesh.shape[replica_axis].  This is the DP x spatial composition — the MD
    analog of dp x tp in an ML framework.
    """
    from .halo import _halo_local_energy_builder, halo_compatible

    if halo_compatible(system, mesh.shape[space_axis]):
        inner = _halo_local_energy_builder(system, space_axis,
                                           mesh.shape[space_axis])
    else:
        inner = _local_energy_builder(system, space_axis,
                                      mesh.shape[space_axis])

    def local_batch(positions_chunk):          # [R_local, N, 3] on device
        return jax.vmap(inner)(positions_chunk)

    sharded = jax.shard_map(
        local_batch, mesh=mesh,
        in_specs=P(replica_axis),
        out_specs=P(replica_axis),
        check_vma=False,
    )
    return jax.jit(sharded)
