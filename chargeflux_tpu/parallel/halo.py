"""Spatial slab decomposition with ppermute halo exchange.

The first-class scale-out path (SURVEY §2/§5): the cell grid is
sliced into contiguous x-plane slabs, one per device along the mesh axis.
Each device

* bins ONLY its slab's atoms (a [N, n_cells/D] one-hot cumsum — 1/D of the
  binning work; the full-grid rebuild of the work-sharding path is gone),
* gathers its local cell blocks (row-wise, inverse-permutation backward —
  same trick as cells.blockify),
* receives ONE boundary plane of blocks from its +x ring neighbor via
  ``jax.lax.ppermute`` (the half-shell's dx is in {0, 1}, so
  only the high halo is consumed; -x cross-boundary pairs are the lower
  device's dx=+1 shift),
* runs the concat-layout pair-tile walk (cells.py's production layout) on
  the extended [gxl+1, gy, gz, cap] slab — x via slicing on the extended
  axis, y/z via rolls with static boundary image offsets.

Forces come from jax.grad through shard_map: the transpose of a ppermute is
the reverse ppermute and the transpose of the replicated-in program psums
force partials — the halo force exchange of a classical spatial-decomposition
MD code falls out of AD.

Out-designs the reference's vestigial multi-context exclusion-tile split
(CudaCoulKernels.cpp:477-481), which never parallelized the pair sum at all.

Decomposition (``halo_decomp``): pure x-slabs (one ppermute/eval) whenever
gx divides ndev's share; otherwise — or past gx devices — a 2-D x-by-y
brick decomposition with a TWO-STAGE exchange (extend
y both ways, then send the y-extended x boundary plane: 3 ppermutes,
corners compose for free), scaling to gx*gy devices.
``parallel.shard.make_sharded_energy_fn`` falls back to work sharding when
neither fits.

Known scale bound: _local_bin uses the flat [N, n_local] one-hot cumsum
(1/D of the single-chip binning).  At ~1M atoms per slab the cumsum
intermediate outgrows HBM; the fix is reusing cells.build_cell_list_full's
two-stage hierarchical ranking per slab (not yet wired — today's largest
config, 100k on 8 devices, bins ~4 MB per device).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..cells import (HALF_SHELL, _boundary_crossing, gather_rows,
                     rank_into_slots, wrap_offsets)
from ..charges import effective_charges
from ..energy import dispersion_energy, resolve_recip_method
from ..ewald import reciprocal_energy_from_sf, self_energy, structure_factors
from ..ops.erfc import erfc_fast
from ..pairs import frac_coords
from ..units import ONE_4PI_EPS0
from .shard import _ceil_to, _excl_chunk_energy


def halo_decomp(system, ndev: int):
    """Pick the (Dx, Dy) slab factorization for ``ndev`` devices, or None
    if no halo decomposition fits.  Prefers pure x-slabs (Dy == 1: one
    ppermute per eval); when gx doesn't divide — or ndev exceeds gx —
    falls to the 2-D x-by-y decomposition (3 ppermutes)
    with the largest Dx whose complement divides gy."""
    spec = system.spec
    if not (spec.pbc and spec.direct_method == "cell"
            and spec.cell_grid is not None):
        return None
    gx, gy, _ = spec.cell_grid
    for dx in range(min(ndev, gx), 0, -1):
        if ndev % dx:
            continue
        dy = ndev // dx
        if gx % dx == 0 and dy <= gy and gy % dy == 0:
            return (dx, dy)
    return None


def halo_compatible(system, ndev: int) -> bool:
    return halo_decomp(system, ndev) is not None


def _local_bin(positions, system, dev_x, dev_y, gxl, gyl):
    """Bin this device's slab: slots [gxl*gyl*gz, cap] (sentinel N) and
    inv_slot [N] (sentinel = n_local_slots for atoms owned elsewhere).

    Uses the shared two-stage hierarchical ranking (cells.rank_into_slots)
    with the slab ownership mask — a flat [N, n_local] one-hot would cost
    O(N * n_local) device memory and wall the halo path at ~1M atoms; the
    two-stage form is O(N * gxl*gyl + local_slots * gz), the same scaling
    fix the single-device binner has."""
    spec = system.spec
    cap = spec.cell_capacity
    n = positions.shape[0]
    gvec = jnp.asarray(np.asarray(spec.cell_grid), positions.dtype)
    frac = frac_coords(positions, system.box)
    frac = frac - jnp.floor(frac)
    ci = jnp.clip((frac * gvec).astype(jnp.int32), 0,
                  jnp.asarray(np.asarray(spec.cell_grid) - 1, jnp.int32))
    lcx = ci[:, 0] - dev_x * gxl
    lcy = ci[:, 1] - dev_y * gyl
    owned = (lcx >= 0) & (lcx < gxl) & (lcy >= 0) & (lcy < gyl)
    col = jnp.where(owned, lcx * gyl + lcy, 0)   # masked rows ignore col
    return rank_into_slots(col, ci[:, 2], owned, n, gxl * gyl,
                           spec.cell_grid[2], cap)


def make_halo_energy_fn(system, mesh: Mesh, axis_name: str = "space",
                        decomp=None):
    """energy(positions [N,3] replicated, box=None) -> scalar replicated;
    direct space computed on x-slabs (or x-by-y bricks, see below) with
    ppermute halo exchange (see module docstring).  Differentiable
    (forces via jax.grad).

    ``decomp=(Dx, Dy)`` picks the slab factorization; default
    :func:`halo_decomp` — pure x-slabs whenever gx divides (one ppermute
    per eval), else the 2-D x-by-y decomposition (two-stage exchange,
    3 ppermutes) that scales past gx devices to gx*gy.

    NPT support: ``box`` may be a *traced* lattice (defaults to
    the creation-time ``system.box``) — slab ownership is fractional, so a
    volume move never re-partitions atoms across devices; validity of the
    static cell grid under the moved box is guarded in-jit exactly like
    the single-chip cell route (energy.py): when any cell plane spacing
    falls below the cutoff the energy (and so every force) NaN-poisons
    instead of silently missing pairs.  ``npt.npt_langevin_trajectory(...,
    energy_fn=...)`` composes with this directly."""
    ndev = mesh.shape[axis_name]
    if decomp is None:
        decomp = halo_decomp(system, ndev)
    spec = system.spec
    if (decomp is None or decomp[0] * decomp[1] != ndev
            or spec.cell_grid is None
            or spec.cell_grid[0] % decomp[0]
            or spec.cell_grid[1] % decomp[1]
            or not spec.pbc or spec.direct_method != "cell"):
        raise ValueError(
            f"halo path needs a pbc cell route whose cell grid factors "
            f"over {ndev} devices (grid {system.spec.cell_grid}, "
            f"decomp {decomp})")
    # The CREATION-time box must cover the grid (a config error otherwise);
    # runtime (barostat) moves are handled by the in-jit poison guard.
    from ..system import box_widths
    widths = np.asarray(box_widths(
        np.asarray(jax.device_get(system.box), np.float64)))
    grid = np.asarray(system.spec.cell_grid)
    if float(np.min(widths / grid)) < system.spec.cutoff:
        raise ValueError(
            f"system box (plane widths {tuple(widths)}) does not cover "
            f"cell grid {tuple(grid)} at cutoff {system.spec.cutoff} — the "
            f"creation-time box must be valid; barostat moves at call time "
            f"are guarded in-jit (pass box= to the returned energy fn)")
    local_energy = _halo_local_energy_builder(system, axis_name, ndev,
                                              decomp=decomp)
    sharded = jax.shard_map(local_energy, mesh=mesh, in_specs=(P(), P()),
                            out_specs=P(), check_vma=False)
    jitted = jax.jit(sharded)

    def energy(positions, box=None):
        b = system.box if box is None else jnp.asarray(
            box, jnp.asarray(system.box).dtype)
        return jitted(positions, b)

    return energy


def _halo_local_energy_builder(system, axis_name: str, ndev: int,
                               decomp=None):
    spec = system.spec
    gx, gy, gz = spec.cell_grid
    cap = spec.cell_capacity
    if decomp is None:
        decomp = halo_decomp(system, ndev)
    ddx, ddy = decomp
    gxl = gx // ddx
    gyl = gy // ddy
    n = system.n_atoms
    n_pad = _ceil_to(n, ndev)
    row_chunk = n_pad // ndev
    e_chunk = _ceil_to(max(system.n_exclusions, 1), ndev) // ndev
    alpha = spec.alpha
    cutoff2 = spec.cutoff * spec.cutoff

    def local_energy(positions, box_in):
        dev = jax.lax.axis_index(axis_name)
        dev_x = dev // ddy
        dev_y = dev % ddy
        dtype = positions.dtype
        # Reciprocal route: the single-device engine's resolver, on the
        # traced positions' dtype.  PME is the distributed SPME (each
        # device spreads its slab's cells onto the mesh, ONE psum of the
        # charge grid, replicated FFT/influence); "xla" is the classical
        # chunked structure-factor sum.
        use_pme = resolve_recip_method(spec, dtype) == "pme"
        # a (possibly traced) barostat-moved box: thread it through
        # everything box-dependent via the pytree-leaf swap (system.with_box)
        sysb = system.with_box(box_in)
        box = sysb.box
        q = effective_charges(positions, sysb)   # replicated, template-fast

        slots, slot_of, overflow = _local_bin(positions, sysb, dev_x,
                                              dev_y, gxl, gyl)

        # -- local blockify (row gather fwd / inverse row gather bwd) -------
        flat = slots.reshape(-1)
        pos_w = positions - wrap_offsets(positions, box)
        table = jnp.concatenate(
            [pos_w, q[:, None],
             0.5 * system.sigma.astype(dtype)[:, None],
             2.0 * jnp.sqrt(system.epsilon.astype(dtype))[:, None],
             jnp.ones((n, 1), dtype),              # validity column
             jnp.zeros((n, 1), dtype)], axis=1)
        table = jnp.concatenate([table, jnp.zeros((1, 8), dtype)], axis=0)
        g8 = gather_rows(table, flat, slot_of).reshape(gxl, gyl, gz, cap, 8)

        # -- halo exchange --------------------------------------------------
        # x: ONE boundary plane from the +x ring neighbor.  The half-shell
        # has dx in {0, 1} only, so only the HIGH x halo is ever consumed:
        # my plane 0 becomes the left neighbor's high halo.  Cross-boundary
        # pairs with the -x neighbor are that neighbor's dx=+1 shift
        # (counted once there); a low x halo would be dead traffic (one
        # wasted ppermute per step, found by HLO inspection).
        # 2-D (ddy > 1): two-stage exchange — extend y FIRST in both
        # directions (interior dx=+1 shifts reach dy=-1, so unlike x the
        # low y halo is live), then send the y-EXTENDED x=0 plane backward
        # along the x ring: the (+x, +-y) corner cells ride the second
        # stage for free.  Global-wrap lattice offsets are applied to each
        # halo plane at exchange time (the sender's y offsets are valid
        # for the receiver: same dev_y), gated on validity so padded slots
        # stay put.
        if box.ndim == 2:
            lx = box[0, 0]
            by0, by1 = box[1, 0], box[1, 1]
        else:
            lx = box[0]
            by0, by1 = jnp.zeros((), dtype), box[1]
        if ddy > 1:
            perm_hi_y = [(dx * ddy + dy_i, dx * ddy + (dy_i - 1) % ddy)
                         for dx in range(ddx) for dy_i in range(ddy)]
            perm_lo_y = [(dx * ddy + dy_i, dx * ddy + (dy_i + 1) % ddy)
                         for dx in range(ddx) for dy_i in range(ddy)]
            hi_y = jax.lax.ppermute(g8[:, 0], axis_name, perm_hi_y)
            lo_y = jax.lax.ppermute(g8[:, gyl - 1], axis_name, perm_lo_y)
            s_hi = jnp.where(dev_y == ddy - 1, 1.0, 0.0).astype(dtype)
            s_lo = jnp.where(dev_y == 0, -1.0, 0.0).astype(dtype)

            def y_shift(plane, s):
                plane = plane.at[..., 0].add(s * by0 * plane[..., 6])
                return plane.at[..., 1].add(s * by1 * plane[..., 6])

            ext_y = jnp.concatenate(
                [y_shift(lo_y, s_lo)[:, None], g8,
                 y_shift(hi_y, s_hi)[:, None]], axis=1)
        else:
            ext_y = g8
        ring_x = [(dx * ddy + dy_i, ((dx - 1) % ddx) * ddy + dy_i)
                  for dx in range(ddx) for dy_i in range(ddy)]
        halo_hi = jax.lax.ppermute(ext_y[0], axis_name, ring_x)
        # crossing the global periodic boundary shifts x by +Lx (for a
        # reduced triclinic lattice the a row is (ax, 0, 0) — still a pure
        # x translation)
        hi_shift = jnp.where(dev_x == ddx - 1, lx, 0.0).astype(dtype)
        halo_hi = halo_hi.at[..., 0].add(hi_shift * halo_hi[..., 6])
        ext = jnp.concatenate([ext_y, halo_hi[None]], axis=0)

        ids = slots.reshape(gxl, gyl, gz, cap)

        # Concat walk layout, as in the single-chip route (cells.py): the
        # 14 half-shell j slabs — x via ext slicing (dx in {0, 1}), y/z
        # via rolls with static boundary image offsets — are concatenated
        # along the slot axis into ONE [cap, 14*cap] pair tile so any
        # minor-axis tile padding is paid once.  The whole tile is wrapped in
        # jax.checkpoint: under plain autodiff the backward pass would
        # otherwise keep the [.., cap, 14*cap] r2/inv_r/sig6 intermediates
        # live in device memory (the single-device route fuses them away with a hand
        # VJP; here recomputation buys the same memory profile).
        yz_ax = (1, 2)

        def offs_yz(dy_, dz_):
            # y/z boundary-wrap lattice offsets per coordinate (the x wrap
            # is handled by the ext slicing + halo hi_shift above); a
            # triclinic y/z wrap also shifts the x (and y) coordinate by
            # the off-diagonal lattice entries.  Only the z part applies
            # when ddy > 1 (y wraps were applied at exchange time).
            cz = jnp.asarray(_boundary_crossing(gz, dz_), dtype).reshape(
                1, 1, gz, 1)
            if ddy > 1:
                cy = jnp.zeros((), dtype)
            else:
                cy = jnp.asarray(_boundary_crossing(gy, dy_),
                                 dtype).reshape(1, gy, 1, 1)
            if box.ndim == 2:
                return (cy * box[1, 0] + cz * box[2, 0],
                        cy * box[1, 1] + cz * box[2, 1],
                        cz * box[2, 2])
            return (jnp.zeros((), dtype), cy * box[1], cz * box[2])

        def tile_energy(ext_in, ids_in):
            if ddy > 1:
                g8_in = jax.lax.slice(
                    ext_in, (0, 1, 0, 0, 0), (gxl, 1 + gyl, gz, cap, 8))
            else:
                g8_in = jax.lax.slice_in_dim(ext_in, 0, gxl, axis=0)
            valid_i = ids_in < n
            xi = [g8_in[..., k] for k in range(3)]
            qi, hi_, si = g8_in[..., 3], g8_in[..., 4], g8_in[..., 5]
            slabs = []
            for (dx_, dy_, dz_) in HALF_SHELL:
                if ddy > 1:
                    sl = jax.lax.slice(
                        ext_in, (dx_, 1 + dy_, 0, 0, 0),
                        (dx_ + gxl, 1 + dy_ + gyl, gz, cap, 8))
                    sl = jnp.roll(sl, -dz_, 2)
                else:
                    sl = jax.lax.slice_in_dim(ext_in, dx_, dx_ + gxl,
                                              axis=0)
                    sl = jnp.roll(sl, (-dy_, -dz_), yz_ax)
                ox, oy, oz = offs_yz(dy_, dz_)
                slabs.append((sl[..., 0] + ox, sl[..., 1] + oy,
                              sl[..., 2] + oz,
                              sl[..., 3], sl[..., 4], sl[..., 5],
                              sl[..., 6] > 0.5))
            cat = lambda k: jnp.concatenate([s[k] for s in slabs], axis=-1)
            xj = [cat(0), cat(1), cat(2)]
            qj, hj, sj, mj = cat(3), cat(4), cat(5), cat(6)
            # self slab (first cap columns): ordered pairs by global atom
            # id; the other 13 slabs take every in-range pair once
            ordered = jnp.concatenate(
                [ids_in[..., :, None] < ids_in[..., None, :],
                 jnp.ones(ids_in.shape[:-1] + (cap, 13 * cap), bool)],
                axis=-1)
            r2 = 0.0
            for k in range(3):
                dk = xi[k][..., :, None] - xj[k][..., None, :]
                r2 = r2 + dk * dk
            mask = (valid_i[..., :, None] & mj[..., None, :]
                    & (r2 < cutoff2) & ordered)
            r2s = jnp.where(mask, r2, 1.0)
            inv_r = jax.lax.rsqrt(r2s)
            qq = ONE_4PI_EPS0 * (qi[..., :, None] * qj[..., None, :])
            if dtype == jnp.float64:
                # exact erfc on the f64 parity path
                r = r2s * inv_r
                coul = qq * inv_r * erfc_fast(alpha * r)
            else:
                # same exp/divide-free polynomial as the single-chip f32
                # walk (cells._concat_tile) — identical numerics across
                # the single-chip and halo routes
                from ..ops.erfc import erf_over_r_eval
                coul = qq * (inv_r - erf_over_r_eval(r2s, alpha,
                                                     spec.cutoff))
            sig2 = ((hi_[..., :, None] + hj[..., None, :]) * inv_r) ** 2
            sig6 = sig2 * sig2 * sig2
            lj = (si[..., :, None] * sj[..., None, :]) * sig6 * (sig6 - 1.0)
            return jnp.sum(jnp.where(mask, coul + lj, 0.0))

        e_dir = jax.checkpoint(tile_energy)(ext, ids)

        # overflow + traced-box-validity safety: the NaN poison term
        # touches every position so every atom's force is poisoned too
        # (same as the 1-device route, energy.py).  The edge check makes
        # barostat (NPT) moves safe: a box shrunk until a cell plane
        # spacing is below the cutoff would make the half-shell walk miss
        # pairs — poison instead.
        from ..pairs import plane_widths
        overflow_tot = jax.lax.psum(overflow, axis_name)
        edge = plane_widths(box) / jnp.asarray(
            np.asarray(spec.cell_grid), dtype)
        bad = (overflow_tot > 0) | jnp.any(edge < spec.cutoff)
        e_dir = e_dir + jnp.sum(positions) * jnp.where(
            bad, jnp.asarray(jnp.nan, dtype), 0.0)

        # -- exclusions: index-chunked (subtract route) ----------------------
        e_excl = _excl_chunk_energy(positions, q, sysb, dev * e_chunk,
                                    e_chunk)

        # -- self: atom-index-chunked ---------------------------------------
        q_pad = jnp.concatenate([q, jnp.zeros(n_pad - n, q.dtype)])
        qs = jax.lax.dynamic_slice_in_dim(q_pad, dev * row_chunk, row_chunk, 0)
        e_self = self_energy(qs, alpha)

        # -- reciprocal -----------------------------------------------------
        if use_pme:
            from ..pme import (influence_function, pme_halo_local_mesh,
                               pme_halo_mesh)

            mesh_grid = pme_halo_mesh(spec, pad_y=ddy > 1)
            q_mesh = jax.lax.psum(
                pme_halo_local_mesh(g8, ids, sysb, dev_x, mesh_grid,
                                    dev_y=dev_y if ddy > 1 else None),
                axis_name)
            qhat = jnp.fft.rfftn(q_mesh)
            d = influence_function(mesh_grid, box, alpha, spec.pme_order,
                                   dtype)
            e_rec = jnp.sum(d * (qhat.real * qhat.real
                                 + qhat.imag * qhat.imag))
        else:
            # classical chunked structure factors (f64 parity/fallback)
            x_pad = jnp.concatenate(
                [positions, jnp.zeros((n_pad - n, 3), dtype)], axis=0)
            xs = jax.lax.dynamic_slice_in_dim(x_pad, dev * row_chunk,
                                              row_chunk, 0)
            sc_part, ss_part = structure_factors(xs, qs, box, spec.kmax)
            sc = jax.lax.psum(sc_part, axis_name)
            ss = jax.lax.psum(ss_part, axis_name)
            e_rec = reciprocal_energy_from_sf(sc, ss, box, alpha, spec.kmax)
        if spec.tail_coeff is not None:
            # replicated (outside the psum), like e_rec — added once
            e_rec = e_rec + dispersion_energy(box, spec, dtype)
        return e_rec + jax.lax.psum(e_dir + e_excl + e_self, axis_name)

    return local_energy
