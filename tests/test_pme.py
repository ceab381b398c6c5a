"""Smooth particle-mesh Ewald (pme.py) vs the classical Ewald sum.

The classical factorized sum (ewald.py, f64) is the converged reference;
PME must land within the tolerance its grid heuristic promises, forces must
be the exact gradient of the computed energy, and the f32 production paths
must hold the <=1e-4 force-RMSE budget vs f64.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chargeflux_tpu.charges import effective_charges
from chargeflux_tpu.energy import _energy, _energy_and_forces
from chargeflux_tpu.ewald import reciprocal_energy
from chargeflux_tpu.models import water_box
from chargeflux_tpu.pme import (bspline, good_fft_size, pme_grid_size,
                                pme_reciprocal_energy)


@pytest.fixture(scope="module")
def box4():
    force, pos, _, box = water_box(n_side=4, flux="bond_angle", seed=9)
    system = force.create_system(box=box, dtype=jnp.float64)
    x = jnp.asarray(pos)
    q = effective_charges(x, system)
    return system, x, q, jnp.asarray(box)


def test_bspline_partition_of_unity():
    # sum_j M_p(t + j) = 1 on the support for any fractional offset
    for order in (4, 6, 8):
        t = jnp.asarray(np.linspace(0.0, 1.0, 17, endpoint=False))
        vals = sum(bspline(t + j, order) for j in range(order))
        np.testing.assert_allclose(np.asarray(vals), 1.0, atol=1e-12)


def test_good_fft_size():
    assert [good_fft_size(n) for n in (1, 7, 11, 63, 65, 97)] == \
        [1, 8, 12, 64, 72, 100]


def test_pme_energy_matches_classical(box4):
    system, x, q, b = box4
    alpha = system.spec.alpha
    e_ref = float(reciprocal_energy(x, q, b, alpha, (33, 33, 33)))
    for tol in (1e-4, 1e-6):
        grid = pme_grid_size(np.asarray(b), alpha, tol)
        e = float(pme_reciprocal_energy(x, q, b, alpha, grid))
        assert abs(e - e_ref) / abs(e_ref) < tol, (tol, grid)


def test_pme_forces_match_classical_within_tol(box4):
    system, x, q, b = box4
    alpha = system.spec.alpha
    g_ref = np.asarray(jax.grad(
        lambda xx: reciprocal_energy(xx, q, b, alpha, (33, 33, 33)))(x))
    rms = np.sqrt(np.mean(g_ref ** 2))
    for tol in (1e-4, 1e-6):
        grid = pme_grid_size(np.asarray(b), alpha, tol)
        g = np.asarray(jax.grad(
            lambda xx: pme_reciprocal_energy(xx, q, b, alpha, grid))(x))
        assert np.sqrt(np.mean((g - g_ref) ** 2)) / rms < tol, (tol, grid)


def test_pme_grad_matches_finite_differences(box4):
    system, x, q, b = box4
    alpha = system.spec.alpha
    grid = pme_grid_size(np.asarray(b), alpha, 1e-5)
    f = lambda xx: pme_reciprocal_energy(xx, q, b, alpha, grid)  # noqa: E731
    g = np.asarray(jax.grad(f)(x))
    rng = np.random.default_rng(0)
    v = rng.standard_normal(x.shape)
    v /= np.linalg.norm(v)
    h = 1e-6
    fd = (float(f(x + h * v)) - float(f(x - h * v))) / (2 * h)
    np.testing.assert_allclose(np.sum(g * np.asarray(v)), fd,
                               rtol=1e-7, atol=1e-9)


def test_pme_dedq_consistent(box4):
    """dE/dq through the spread must match the classical dE/dq."""
    system, x, q, b = box4
    alpha = system.spec.alpha
    grid = pme_grid_size(np.asarray(b), alpha, 1e-6)
    d_pme = np.asarray(jax.grad(
        lambda qq: pme_reciprocal_energy(x, qq, b, alpha, grid))(q))
    d_ref = np.asarray(jax.grad(
        lambda qq: reciprocal_energy(x, qq, b, alpha, (33, 33, 33)))(q))
    scale = np.sqrt(np.mean(d_ref ** 2))
    assert np.sqrt(np.mean((d_pme - d_ref) ** 2)) / scale < 1e-6


def test_total_energy_with_pme_route(box4):
    """recip_method='pme' through the full engine vs the converged classical
    route (kmax bumped well past the heuristic).  Tolerances scale with the
    reciprocal-space energy (~260 kJ/mol here), not the total (which is
    cancellation-prone on this small box)."""
    system, x, _, _ = box4
    sys_ref = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, kmax=(17, 17, 17)))
    sys_pme = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, recip_method="pme"))
    e_ref, f_ref = _energy_and_forces(x, sys_ref)
    e, f = _energy_and_forces(x, sys_pme)
    assert abs(float(e) - float(e_ref)) < 0.1  # ~3e-4 of E_rec
    rms = np.sqrt(np.mean(np.asarray(f_ref) ** 2))
    err = np.sqrt(np.mean((np.asarray(f) - np.asarray(f_ref)) ** 2)) / rms
    assert err < 1e-4


@pytest.mark.parametrize("recip", ["xla", "pme"])
def test_f32_force_rmse_budget(recip):
    """f32 production path force RMSE vs f64 classical: <=1e-4 relative.

    Pins the BF16_BF16_F32_X3 precision choice (ewald.py / pme.py) — fails
    if anyone drops the precision pin.
    """
    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=13)
    sys64 = force.create_system(box=box, dtype=jnp.float64,
                                direct_method="cell")
    x64 = jnp.asarray(pos, jnp.float64)
    _, f64 = _energy_and_forces(x64, sys64)
    rms = np.sqrt(np.mean(np.asarray(f64) ** 2))

    sys32 = force.create_system(box=box, dtype=jnp.float32,
                                direct_method="cell", recip_method=recip)
    x32 = jnp.asarray(pos, jnp.float32)
    _, f32 = _energy_and_forces(x32, sys32)
    err = np.sqrt(np.mean((np.asarray(f32, np.float64)
                           - np.asarray(f64)) ** 2)) / rms
    assert err < 1e-4, err


def test_heuristic_grid_reasonable():
    grid = pme_grid_size(np.array([6.8354] * 3), 3.2427, 1e-4)
    assert all(40 <= g <= 96 for g in grid)
    # finer tolerance -> finer grid
    finer = pme_grid_size(np.array([6.8354] * 3), 3.2427, 1e-6)
    assert all(f > g for f, g in zip(finer, grid))


def test_pme_grid_override():
    """create_system(pme_grid=...) may only RAISE the mesh (finer is more
    accurate); the overridden system's energy must agree with the derived
    mesh within the tolerance budget, and coarser / non-PBC requests must
    raise.  Expert knob — the analog of the reference framework's explicit
    PME-parameter setter; main use is picking a mesh divisible by the cell
    grid so the cell-blocked spread's patch windows stay tight."""
    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=4)
    x = jnp.asarray(pos)
    sys_a = force.create_system(box=box, dtype=jnp.float64,
                                direct_method="cell", recip_method="pme")
    fine = tuple(good_fft_size(g + 8) for g in sys_a.spec.pme_grid)
    sys_b = force.create_system(box=box, dtype=jnp.float64,
                                direct_method="cell", recip_method="pme",
                                pme_grid=fine)
    assert sys_b.spec.pme_grid == fine
    _, f_a = _energy_and_forces(x, sys_a)
    _, f_b = _energy_and_forces(x, sys_b)
    # both meshes satisfy the ewald_tol force-error contract; their
    # mutual force RMSE is bounded by a few tolerance units
    rms = float(np.sqrt(np.mean(np.asarray(f_a) ** 2)))
    err = float(np.sqrt(np.mean((np.asarray(f_a) - np.asarray(f_b)) ** 2)))
    assert err / rms < 5e-4, err / rms
    with pytest.raises(ValueError, match="pme_grid"):
        force.create_system(box=box, dtype=jnp.float64,
                            direct_method="cell",
                            pme_grid=tuple(g - 8 for g in sys_a.spec.pme_grid))
    from chargeflux_tpu.system import CoulForce
    f2 = CoulForce()
    f2.addParticle(0.5, 0.1, 0.1)
    f2.addParticle(-0.5, 0.1, 0.1)
    with pytest.raises(ValueError, match="periodic"):
        f2.create_system(pme_grid=(32, 32, 32))


def test_cell_blocked_spread_matches_dense(box4):
    """The cell-blocked spread (shared blocks, patch matmuls, placement-
    matrix folds) must agree with the dense-separable spread to f64
    roundoff."""
    from chargeflux_tpu import cells
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.pme import pme_cell_reciprocal_energy

    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=3)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    spec = system.spec
    x = jnp.asarray(pos)
    from chargeflux_tpu.charges import effective_charges

    def e_cell(xx):
        qq = effective_charges(xx, system)
        slots, inv, _ = cells.build_cell_list_full(
            xx, system.box, spec.cell_grid, spec.cell_capacity)
        blocks = cells.blockify(xx, qq, system, slots, inv)
        return pme_cell_reciprocal_energy(
            blocks, slots.reshape(blocks.x.shape), system)

    def e_dense(xx):
        qq = effective_charges(xx, system)
        return pme_reciprocal_energy(xx, qq, system.box, spec.alpha,
                                     spec.pme_grid, spec.pme_order)

    e1, e2 = float(e_cell(x)), float(e_dense(x))
    np.testing.assert_allclose(e1, e2, rtol=1e-12)
    g1 = np.asarray(jax.grad(e_cell)(x))
    g2 = np.asarray(jax.grad(e_dense)(x))
    np.testing.assert_allclose(g1, g2, rtol=1e-8, atol=1e-10)


def test_cell_spread_exact_under_reuse_drift():
    """Neighbor-state reuse lets atoms drift up to skin/2 past their
    rebuild-time cell before the freshness guard fires; the cell-blocked
    spread's patches must keep full B-spline support for that whole range
    (spec.pme_slack).  This config (large floor() leftover -> skin/2 =
    0.178 nm; tight Ewald tol -> mesh spacing 0.063 nm) measures a silent
    8e-7 relative energy error when the slack is forced to zero — wrong
    reciprocal forces with no NaN.  The drift is axis-aligned at 98% of
    the guard bound: the patch edge is where truncation bites."""
    from chargeflux_tpu import cells as cmod
    from chargeflux_tpu.charges import effective_charges
    from chargeflux_tpu.neighbors import (build_neighbor_state,
                                          neighbor_state_fresh, skin_radius)
    from chargeflux_tpu.pme import pme_cell_reciprocal_energy

    force, pos, _, box = water_box(n_side=12, flux="bond_angle", cutoff=0.9,
                                   density_spacing=0.314, seed=21)
    force.setEwaldErrorTolerance(1e-6)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    spec = system.spec
    h = float(np.max(np.asarray(box) / np.asarray(spec.pme_grid)))
    half_skin = float(skin_radius(system)) * 0.5
    assert half_skin > 2 * h      # the config actually exercises the bug
    assert min(spec.pme_slack) >= 2

    x0 = jnp.asarray(pos, jnp.float64)
    nb = build_neighbor_state(x0, system)
    rng = np.random.default_rng(3)
    sgn = np.where(rng.random(len(pos)) < 0.5, -1.0, 1.0)
    d = np.zeros_like(np.asarray(pos))
    d[:, 0] = sgn * 0.98 * half_skin
    x1 = x0 + jnp.asarray(d)
    assert bool(neighbor_state_fresh(nb, x1, system))   # guard passes

    q1 = effective_charges(x1, system)
    ids = nb.slots.reshape(spec.cell_grid + (spec.cell_capacity,))
    b_frozen = cmod.blockify(x1, q1, system, nb.slots, nb.inv_slot,
                             wrap=nb.wrap)
    e_frozen = float(pme_cell_reciprocal_energy(b_frozen, ids, system))

    slots2, inv2, ov2 = cmod.build_cell_list_full(
        x1, system.box, spec.cell_grid, spec.cell_capacity)
    assert int(ov2) == 0
    b_fresh = cmod.blockify(x1, q1, system, slots2, inv2)
    ids2 = slots2.reshape(b_fresh.x.shape)
    e_fresh = float(pme_cell_reciprocal_energy(b_fresh, ids2, system))
    assert abs(e_frozen - e_fresh) / abs(e_fresh) < 1e-10


def test_pme_slack_guard_poisons_excess_drift_under_box_growth():
    """Traced-box safety for the PME patch slack (review r2): pme_slack
    was sized from the creation-time skin, so under barostat growth an
    atom may legally drift (freshness guard: current skin/2) further than
    the static patch headroom — outermost B-spline taps would silently
    truncate.  The energy must NaN-poison when the actual drift exceeds
    the slack budget in current mesh units, and stay finite (and
    correct) below it."""
    from chargeflux_tpu.energy import _energy
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.neighbors import build_neighbor_state, skin_radius

    force, pos, _, box = water_box(n_side=8, cutoff=0.55)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", recip_method="pme")
    spec = system.spec
    s = 1.3
    sys_big = system.with_box(s * jnp.asarray(box))
    x_big = s * jnp.asarray(pos)
    nb = build_neighbor_state(x_big, sys_big)

    h = s * np.asarray(box) / np.asarray(spec.pme_grid)
    budget = float(np.min(np.asarray(spec.pme_slack) * h))
    skin_now = float(skin_radius(sys_big))
    # the grown box really does allow more drift than the static slack
    assert 0.5 * skin_now > budget

    assert np.isfinite(float(_energy(x_big, sys_big, nb=nb)))
    x_ok = x_big.at[0, 0].add(0.8 * budget)
    assert np.isfinite(float(_energy(x_ok, sys_big, nb=nb)))
    x_bad = x_big.at[0, 0].add(min(1.2 * budget, 0.49 * skin_now))
    assert np.isnan(float(_energy(x_bad, sys_big, nb=nb)))
    # forces poison too (force-only consumers must see the failure)
    g = jax.grad(lambda xx: _energy(xx, sys_big, nb=nb))(x_bad)
    assert np.isnan(np.asarray(g)).all()
