"""Host-side triage for NaN-poisoned trajectories.

The engine makes failure VISIBLE by design (CLAUDE.md invariant): three
distinct conditions poison the energy/forces to NaN inside jit rather than going silently wrong —

1. **cell-list overflow** at a rebuild: a density fluctuation put more
   atoms in a cell than the trace-time ``cell_capacity``
   (cells.build_cell_list; the reference analog would silently corrupt
   its neighbor tiles);
2. **stale neighbor state**: a reused binning was consumed after an atom
   moved past skin/2 (integrate.make_nb_energy_fn's freshness guard);
3. **dynamics blowup**: the integrator step itself produced non-finite
   positions (timestep too large / unequilibrated start).

All three look identical from the outside (NaN energies).  This module
tells the user which one fired and what to change, from the last finite
state they hold.
"""

from __future__ import annotations

import numpy as np

import jax


def max_cell_occupancy(positions, system) -> int:
    """Densest-cell atom count for ``positions`` under the system's cell
    grid (NumPy, same wrap/clip convention as cells.build_cell_list)."""
    spec = system.spec
    x = np.asarray(jax.device_get(positions), dtype=np.float64)
    box = np.asarray(jax.device_get(system.box), dtype=np.float64)
    grid = np.asarray(spec.cell_grid)
    frac = x @ np.linalg.inv(box) if box.ndim == 2 else x / box
    frac -= np.floor(frac)
    ci = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
    flat = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    return int(np.bincount(flat, minlength=int(grid.prod())).max())


def diagnose_nan(positions, system, nb=None, dt=None) -> dict:
    """Classify why a trajectory NaN-poisoned, from the last *finite*
    state (positions and, if the loop reused one, its neighbor state).

    Returns a dict with ``cause`` in {"non_finite_positions",
    "cell_overflow", "stale_neighbor_state", "none"}, plus a
    human-readable ``suggestion`` (and ``max_occupancy`` /
    ``cell_capacity`` for the overflow case).  Checks are ordered by
    precedence: non-finite positions mask everything downstream.
    """
    x = np.asarray(jax.device_get(positions))
    if not np.all(np.isfinite(x)):
        return {
            "cause": "non_finite_positions",
            "suggestion": (
                "the poison already propagated into the coordinates — "
                "diagnose from an earlier (finite) state; if the earlier "
                "state is clean, the integrator step itself diverged: "
                "reduce dt (flexible water needs <=0.5 fs whole-step or "
                "an r-RESPA inner tier), equilibrate with a strong "
                "thermostat before production, or minimize first"),
        }

    spec = system.spec
    if spec.direct_method == "cell":
        from ..cells import validate_cell_list
        overflow = validate_cell_list(positions, system)
        if overflow > 0:
            occ = max_cell_occupancy(positions, system)
            want = -(-max(occ + 8, int(spec.cell_capacity) + 8) // 8) * 8
            return {
                "cause": "cell_overflow",
                "overflow": int(overflow),
                "max_occupancy": occ,
                "cell_capacity": int(spec.cell_capacity),
                "suggestion": (
                    f"a cell holds {occ} atoms but cell_capacity is "
                    f"{spec.cell_capacity}; rebuild the system with "
                    f"create_system(..., cell_capacity={want}).  Molecules "
                    "move as units, so per-cell fluctuations run ~sqrt("
                    "atoms/molecule) above the Poisson estimate the "
                    "default uses — hot/unequilibrated systems need the "
                    "extra headroom"),
            }

    if nb is not None:
        from ..neighbors import neighbor_state_fresh, skin_radius
        fresh = bool(jax.device_get(neighbor_state_fresh(nb, positions,
                                                         system)))
        if not fresh:
            skin = float(jax.device_get(skin_radius(system)))
            hint = ""
            if dt is not None:
                from ..neighbors import suggest_rebuild_interval
                hint = (f"; suggest_rebuild_interval gives "
                        f"{suggest_rebuild_interval(system, dt)} at this dt")
            return {
                "cause": "stale_neighbor_state",
                "skin": skin,
                "suggestion": (
                    "an atom moved past skin/2 since the last rebuild: "
                    "lower rebuild_every, enlarge the skin (skin_frac at "
                    "create_system), or slow the dynamics" + hint),
            }

    # collinear flux angles: the energy stays finite (clamped acos) but
    # the FORCE is singular there — |dtheta/dx| ~ 1/sin(theta)
    # (PARITY.md defect #2; tests/test_edges.py pins the contract)
    worst = _min_flux_angle_sine(positions, system)
    if worst is not None and worst[0] < 1e-6:
        s, idx = worst
        return {
            "cause": "collinear_flux_angle",
            "min_sin_theta": float(s),
            "angle_index": int(idx),
            "suggestion": (
                f"flux angle #{idx} is (near-)collinear (sin theta = "
                f"{s:.2e}): the flux-angle force diverges as 1/sin(theta) "
                "— a property of the model.  Fix the geometry (minimize "
                "first), stiffen the bonded angle term, or remove the "
                "flux term on this angle"),
        }

    return {
        "cause": "none",
        "suggestion": (
            "this state looks healthy (finite, no overflow, fresh "
            "neighbors) — if a run from here still NaNs, it poisons "
            "mid-chunk: rerun with rebuild_every=1 and guard on, or step "
            "manually to bisect"),
    }


def _min_flux_angle_sine(positions, system):
    """(min |sin theta|, argmin) over the flux angles, or None if the
    system has none.  Host-side NumPy, min-image deltas like the engine."""
    idx = np.asarray(jax.device_get(system.angle_idx))
    if idx.shape[0] == 0:
        return None
    x = np.asarray(jax.device_get(positions), dtype=np.float64)
    box = (np.asarray(jax.device_get(system.box), dtype=np.float64)
           if system.spec.pbc else None)

    def delta(a, b):
        d = x[a] - x[b]
        if box is not None:
            if box.ndim == 2:
                # sequential reduced-form wrap (pairs.delta_periodic)
                for ax in (2, 1, 0):
                    d -= box[ax] * np.floor(
                        d[:, ax:ax + 1] / box[ax, ax] + 0.5)
            else:
                d -= box * np.floor(d / box + 0.5)
        return d

    d21 = delta(idx[:, 0], idx[:, 1])
    d23 = delta(idx[:, 2], idx[:, 1])
    cross = np.cross(d21, d23)
    sin = (np.linalg.norm(cross, axis=1)
           / (np.linalg.norm(d21, axis=1) * np.linalg.norm(d23, axis=1)))
    k = int(np.argmin(sin))
    return float(sin[k]), k
