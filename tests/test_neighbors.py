"""Neighbor-state reuse (skin radius, amortized rebuilds) — exactness.

The reused binning must give bit-level-identical physics to per-step
rebuilds while displacements stay under skin/2, including across periodic
boundaries (frozen wrap offsets), and must rebuild itself when exceeded.
"""

import numpy as np

import jax
import jax.numpy as jnp

from chargeflux_tpu.energy import _energy, _energy_and_forces
from chargeflux_tpu.integrate import (MDState, init_state, init_state_nb,
                                      make_energy_fn, make_nb_energy_fn,
                                      nve_trajectory, nve_trajectory_nb)
from chargeflux_tpu.models import WATER_MASSES, water_box
from chargeflux_tpu.neighbors import (build_neighbor_state,
                                      neighbor_state_fresh,
                                      refresh_neighbor_state, skin_radius)


def _system():
    force, pos, masses, box = water_box(n_side=7, flux="bond_angle",
                                        cutoff=0.65, seed=21)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    return system, jnp.asarray(pos), jnp.asarray(np.asarray(masses))


def test_energy_with_fresh_nb_matches_plain():
    system, x, _ = _system()
    nb = build_neighbor_state(x, system)
    e0 = float(_energy(x, system))
    e1 = float(_energy(x, system, nb=nb))
    assert e0 == e1


def test_reuse_is_exact_under_small_displacement():
    system, x, _ = _system()
    skin = float(skin_radius(system))
    assert skin > 0.05
    nb = build_neighbor_state(x, system)
    rng = np.random.default_rng(0)
    # move everything by < skin/2 (including atoms near the boundary)
    x2 = x + jnp.asarray(rng.uniform(-0.4, 0.4, x.shape)) * (skin / 2) / 0.7
    assert bool(neighbor_state_fresh(nb, x2, system))
    e_reuse, f_reuse = _energy_and_forces(x2, system, nb=nb)
    e_fresh, f_fresh = _energy_and_forces(x2, system)
    np.testing.assert_allclose(float(e_reuse), float(e_fresh), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(f_reuse), np.asarray(f_fresh),
                               rtol=1e-9, atol=1e-10)


def test_refresh_rebuilds_past_half_skin():
    system, x, _ = _system()
    skin = float(skin_radius(system))
    nb = build_neighbor_state(x, system)
    x2 = x.at[0, 0].add(0.7 * skin)
    assert not bool(neighbor_state_fresh(nb, x2, system))
    nb2 = refresh_neighbor_state(nb, x2, system)
    fresh = build_neighbor_state(x2, system)
    np.testing.assert_array_equal(np.asarray(nb2.slots),
                                  np.asarray(fresh.slots))
    np.testing.assert_array_equal(np.asarray(nb2.x_ref), np.asarray(x2))


def test_nb_trajectory_matches_per_step_rebuild():
    system, x, masses = _system()
    e_plain = make_energy_fn(system)
    e_nb, init_nb = make_nb_energy_fn(system)
    dt = 5e-5
    v0 = jnp.zeros_like(x)
    s_plain = init_state(x, v0, e_plain)
    s_nb = init_state_nb(x, v0, e_nb, init_nb)
    _, etot_plain = nve_trajectory(s_plain, e_plain, masses, dt, 25)
    _, etot_nb = nve_trajectory_nb(s_nb, e_nb, init_nb, masses, dt, 25,
                                   rebuild_every=10)
    np.testing.assert_allclose(np.asarray(etot_nb), np.asarray(etot_plain),
                               rtol=1e-10)


def test_packed_trajectory_matches_stepwise_api():
    """nve_trajectory_nb's packed [N, 9] scan carry (one buffer in place of
    three narrow [N, 3] carries) must be a pure layout change: identical physics to driving nve_step_nb by hand."""
    from chargeflux_tpu.integrate import kinetic_energy, nve_step_nb

    system, x, masses = _system()
    e_nb, init_nb = make_nb_energy_fn(system)
    dt = 5e-5
    v0 = jnp.zeros_like(x)
    s = init_state_nb(x, v0, e_nb, init_nb)
    etots = []
    for i in range(7):
        if i % 3 == 0:
            s = s._replace(nb=init_nb(s.positions))
        s = nve_step_nb(s, e_nb, masses, dt)
        etots.append(float(s.potential
                           + kinetic_energy(s.velocities, masses)))

    s0 = init_state_nb(x, v0, e_nb, init_nb)
    final, etot_traj = nve_trajectory_nb(s0, e_nb, init_nb, masses, dt, 7,
                                         rebuild_every=3)
    # jit(scan) vs eager stepwise reassociates fp sums; ~1e-12 rel wiggle
    np.testing.assert_allclose(np.asarray(etot_traj), np.asarray(etots),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(final.positions),
                               np.asarray(s.positions), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(final.velocities),
                               np.asarray(s.velocities), rtol=1e-10,
                               atol=1e-12)


def test_zero_skin_state_fresh_at_rebuild_positions():
    """A zero-skin grid (commensurate box, skin_frac=0) must read FRESH at
    the exact rebuild positions — regression for the strict-< compare that
    NaN-poisoned every step of an exact rebuild_every=1 trajectory."""
    import chargeflux_tpu as cf
    from chargeflux_tpu.neighbors import (build_neighbor_state,
                                          neighbor_state_fresh, skin_radius)
    force = cf.CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(0.5)
    rng = np.random.default_rng(0)
    for _ in range(64):
        force.addParticle(0.1, 0.3, 0.2)
    box = np.array([4.0, 4.0, 4.0])
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", skin_frac=0.0)
    assert float(skin_radius(system)) == 0.0
    x = jnp.asarray(rng.uniform(0, 4, (64, 3)))
    nb = build_neighbor_state(x, system)
    assert bool(neighbor_state_fresh(nb, x, system))
    # any movement at zero skin is stale
    assert not bool(neighbor_state_fresh(nb, x + 1e-6, system))


def test_packed_carry_modes_are_pure_layout_changes():
    """The PACKED_CARRY_MODE representations ("barrier", "flat") must be
    bitwise identical to
    the default packed [N, 9] carry: same arithmetic, different buffer
    layout only."""
    import chargeflux_tpu.integrate as integrate

    system, x, masses = _system()
    e_nb, init_nb = make_nb_energy_fn(system)
    dt = 5e-5
    s0 = init_state_nb(x, jnp.zeros_like(x), e_nb, init_nb)

    results = {}
    modes = ("packed", "barrier", "flat", "xfbarrier")
    for mode in modes:
        old = integrate.PACKED_CARRY_MODE
        integrate.PACKED_CARRY_MODE = mode
        try:
            final, etot = nve_trajectory_nb(s0, e_nb, init_nb, masses, dt,
                                            7, rebuild_every=3)
        finally:
            integrate.PACKED_CARRY_MODE = old
        results[mode] = (np.asarray(final.positions),
                         np.asarray(final.velocities), np.asarray(etot))

    for mode in modes[1:]:
        for a, b in zip(results["packed"], results[mode]):
            np.testing.assert_array_equal(a, b, err_msg=mode)
