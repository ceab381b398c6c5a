"""Rigid-water RATTLE constraint tests.

The reference plugin runs inside OpenMM, which supplies SETTLE/CCMA rigid
constraints around it (SURVEY §1 L0); constraints.py is this engine's
replacement.  Contract: the position projection restores every bond to
its target exactly, matches an independently written iterative SHAKE
oracle, preserves momentum; the velocity projection zeroes bond-direction
relative velocities; the constrained integrators conserve energy at the
2 fs step rigid water exists to enable.
"""

import jax
import jax.numpy as jnp
import numpy as np

import chargeflux_tpu as cf
from chargeflux_tpu.constraints import (
    RigidWaterParams,
    constraint_residuals,
    project_positions,
    project_velocities,
    rattle_langevin_trajectory,
    rattle_nve_trajectory,
)
from chargeflux_tpu.integrate import kinetic_energy, make_energy_fn
from chargeflux_tpu.models import rigid_water_box

_BONDS = ((0, 1), (0, 2), (1, 2))


def _shake_oracle(x_old, x_unc, targets2, inv_m, tol=1e-14, iters=2000):
    """Independent per-molecule iterative SHAKE (NumPy f64): corrections
    along the OLD bond directions, one bond at a time, to convergence."""
    x = np.asarray(x_unc, np.float64).reshape(-1, 3, 3).copy()
    xo = np.asarray(x_old, np.float64).reshape(-1, 3, 3)
    for mol in range(x.shape[0]):
        for _ in range(iters):
            worst = 0.0
            for k, (i, j) in enumerate(_BONDS):
                d = x[mol, i] - x[mol, j]
                diff = d @ d - targets2[k]
                worst = max(worst, abs(diff))
                d_old = xo[mol, i] - xo[mol, j]
                g = diff / (2.0 * (d @ d_old) * (inv_m[i] + inv_m[j]))
                x[mol, i] -= g * d_old * inv_m[i]
                x[mol, j] += g * d_old * inv_m[j]
            if worst < tol:
                break
    return x.reshape(-1, 3)


def _setup(n_side=2, seed=31):
    force, pos, masses, box, params = rigid_water_box(n_side=n_side,
                                                      cutoff=0.45, seed=seed)
    return (force, jnp.asarray(pos), jnp.asarray(np.asarray(masses)), box,
            params)


def test_position_projection_matches_shake_oracle():
    _force, x, m, _box, params = _setup()
    rng = np.random.default_rng(32)
    x_unc = x + jnp.asarray(0.005 * rng.standard_normal(x.shape))

    x_new = project_positions(x, x_unc, params)
    res = np.asarray(constraint_residuals(x_new, params))
    assert np.abs(res).max() < 1e-12, np.abs(res).max()

    ref = _shake_oracle(np.asarray(x), np.asarray(x_unc),
                        np.asarray(params.targets2),
                        np.asarray(params.inv_m))
    np.testing.assert_allclose(np.asarray(x_new), ref, rtol=0, atol=1e-10)

    # the correction is a pure internal impulse: per-molecule momentum
    # (mass-weighted displacement) is exactly preserved
    dm = (np.asarray(x_new) - np.asarray(x_unc)).reshape(-1, 3, 3)
    mass = np.array([15.999, 1.008, 1.008])[None, :, None]
    p = (mass * dm).sum(axis=1)
    assert np.abs(p).max() < 1e-12


def test_settle_matches_newton_to_machine_precision():
    """SETTLE is the closed-form solution of the SAME SHAKE equations the
    Newton path iterates (Miyamoto & Kollman 1992) — on MD-size
    violations the two must agree to rounding, and the SETTLE output
    must satisfy the constraints exactly and conserve per-molecule
    momentum (pure internal impulse)."""
    from chargeflux_tpu.constraints import settle_positions

    _force, x, _m, _box, params = _setup()
    rng = np.random.default_rng(35)
    x_unc = x + jnp.asarray(0.005 * rng.standard_normal(x.shape))

    x_newton = project_positions(x, x_unc, params, n_iter=8,
                                 method="newton")
    x_settle = settle_positions(x, x_unc, params)
    np.testing.assert_allclose(np.asarray(x_settle), np.asarray(x_newton),
                               rtol=0, atol=1e-12)

    res = np.asarray(constraint_residuals(x_settle, params))
    assert np.abs(res).max() < 1e-13, np.abs(res).max()

    dm = (np.asarray(x_settle) - np.asarray(x_unc)).reshape(-1, 3, 3)
    mass = np.array([15.999, 1.008, 1.008])[None, :, None]
    assert np.abs((mass * dm).sum(axis=1)).max() < 1e-12

    # the method= arg and the module default dispatch to the same code
    x_via_dispatch = project_positions(x, x_unc, params, method="settle")
    np.testing.assert_array_equal(np.asarray(x_via_dispatch),
                                  np.asarray(x_settle))


def test_settle_poisons_on_degenerate_proposal():
    """A proposal so wild no rotation can restore the triangle makes a
    sqrt argument negative — the molecule NaN-poisons (visible), never
    silently approximates."""
    from chargeflux_tpu.constraints import settle_positions

    _force, x, _m, _box, params = _setup()
    rng = np.random.default_rng(36)
    x_wild = x + jnp.asarray(5.0 * rng.standard_normal(x.shape))
    x_new = settle_positions(x, x_wild, params)
    assert not bool(jnp.all(jnp.isfinite(x_new)))


def test_position_projection_poisons_on_divergence():
    """An unconstrained step too wild for Newton to recover NaN-poisons
    (visible failure, like cell overflow) instead of returning a quietly
    wrong geometry."""
    _force, x, _m, _box, params = _setup()
    rng = np.random.default_rng(33)
    x_wild = x + jnp.asarray(5.0 * rng.standard_normal(x.shape))
    x_new = project_positions(x, x_wild, params)
    assert not bool(jnp.all(jnp.isfinite(x_new)))


def test_velocity_projection_zeroes_bond_rates():
    _force, x, m, _box, params = _setup(seed=34)
    v = cf.maxwell_velocities(m, 300.0, jax.random.PRNGKey(0))
    v_new = project_velocities(x, v, params)
    xm = np.asarray(x).reshape(-1, 3, 3)
    vm = np.asarray(v_new).reshape(-1, 3, 3)
    for i, j in _BONDS:
        rate = np.sum((xm[:, i] - xm[:, j]) * (vm[:, i] - vm[:, j]), axis=-1)
        assert np.abs(rate).max() < 1e-12
    # total momentum unchanged
    p0 = np.asarray(jnp.sum(m[:, None] * v, axis=0))
    p1 = np.asarray(jnp.sum(m[:, None] * v_new, axis=0))
    np.testing.assert_allclose(p0, p1, rtol=0, atol=1e-10)


def test_rigid_nve_two_fs_conserves():
    """Constrained NVE at dt = 2 fs: rigid water has no fast internal
    modes, so the full electrostatics+LJ step conserves at the timestep
    flexible water cannot take at all; bonds stay on target through the
    whole scan."""
    force, x, m, box, params = _setup(n_side=3, seed=35)
    system = force.create_system(box=box, dtype=jnp.float64)
    e_fn = make_energy_fn(system)
    v0 = cf.maxwell_velocities(m, 300.0, jax.random.PRNGKey(1))

    (xf, vf, _ff, e_pot), etots = rattle_nve_trajectory(
        x, v0, e_fn, m, dt=2e-3, n_steps=200, params=params)
    etots = np.asarray(etots)
    assert np.all(np.isfinite(etots))
    ke = abs(float(kinetic_energy(v0, m))) + 1.0
    drift = np.abs(etots - etots[0]).max() / ke
    # measured 0.034 (bounded oscillation incl. the lattice-start
    # transient); flexible water at this dt is simply unstable
    assert drift <= 0.06, drift
    res = np.asarray(constraint_residuals(xf, params))
    assert np.abs(res).max() < 1e-10


def test_rigid_langevin_thermalizes_with_dof_accounting():
    force, x, m, box, params = _setup(n_side=3, seed=36)
    system = force.create_system(box=box, dtype=jnp.float64)
    e_fn = make_energy_fn(system)
    (xf, vf, _ff, _e), kes = rattle_langevin_trajectory(
        x, jnp.zeros_like(x), e_fn, m, dt=2e-3, temperature=300.0,
        friction=50.0, key=jax.random.PRNGKey(2), n_steps=400,
        params=params)
    kes = np.asarray(kes)
    assert np.all(np.isfinite(kes))
    n_dof = 3 * x.shape[0] - params.n_constraints
    temps = 2.0 * kes[200:] / (n_dof * cf.BOLTZ)
    mean_t = float(temps.mean())
    assert 0.7 * 300.0 < mean_t < 1.3 * 300.0, mean_t
    # the constrained-DoF temperature() agrees with the manual accounting
    t_fn = float(cf.temperature(vf, m, n_constraints=params.n_constraints))
    t_manual = float(2.0 * kinetic_energy(vf, m) / (n_dof * cf.BOLTZ))
    np.testing.assert_allclose(t_fn, t_manual, rtol=1e-12)
    res = np.asarray(constraint_residuals(xf, params))
    assert np.abs(res).max() < 1e-10


def test_rigid_langevin_nb_cell_route():
    """Production rigid driver: neighbor-state reuse on the cell route at
    dt = 2 fs, constraints held, thermalizes from rest."""
    from chargeflux_tpu.integrate import init_state_nb, make_nb_energy_fn
    from chargeflux_tpu.constraints import rattle_langevin_trajectory_nb

    force, pos, masses, box, params = rigid_water_box(n_side=10, seed=37,
                                                      dtype=jnp.float64)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", cell_capacity=192)
    e_fn, init_nb = make_nb_energy_fn(system)
    x = jnp.asarray(pos)
    m = jnp.asarray(np.asarray(masses))
    s0 = init_state_nb(x, jnp.zeros_like(x), e_fn, init_nb)
    s1, kes = rattle_langevin_trajectory_nb(
        s0, e_fn, init_nb, m, dt=2e-3, temperature=300.0, friction=20.0,
        key=jax.random.PRNGKey(4), n_steps=30, rebuild_every=3,
        params=params)
    kes = np.asarray(kes)
    assert kes.shape == (30,)
    assert np.all(np.isfinite(kes))
    assert np.isfinite(float(s1.potential))
    assert kes[-1] > kes[0]
    res = np.asarray(constraint_residuals(s1.positions, params))
    assert np.abs(res).max() < 1e-10


# ---------------------------------------------------------------------------
# General distance constraints (parallel SHAKE/RATTLE)
# ---------------------------------------------------------------------------


def _general_from_rigid(params, masses):
    """DistanceConstraints equivalent of a RigidWaterParams template."""
    from chargeflux_tpu.constraints import DistanceConstraints

    pairs, lengths = [], []
    t = np.sqrt(np.asarray(params.targets2, np.float64))
    for mol in range(params.count):
        base = params.offset + 3 * mol
        for k, (i, j) in enumerate(_BONDS):
            pairs.append((base + i, base + j))
            lengths.append(t[k])
    return DistanceConstraints.create(pairs, lengths, masses)


def test_general_constraints_match_rigid_water_projection():
    """The Jacobi-SHAKE route and the closed-form 3x3 Newton route solve
    the same fixed-point equations (corrections along old bond directions,
    mass-weighted): projections must agree to convergence tolerance on a
    perturbed rigid-water box, positions AND velocities."""
    _force, x, m, _box, params = _setup()
    gen = _general_from_rigid(params, m)
    rng = np.random.default_rng(5)
    x_unc = x + jnp.asarray(rng.normal(0, 0.004, x.shape))
    x_a = project_positions(x, x_unc, params)
    x_b = project_positions(x, x_unc, gen)
    np.testing.assert_allclose(np.asarray(x_b), np.asarray(x_a),
                               rtol=0, atol=1e-9)
    v_unc = jnp.asarray(rng.normal(0, 1.0, x.shape))
    v_a = project_velocities(x_a, v_unc, params)
    v_b = project_velocities(x_a, v_unc, gen)
    np.testing.assert_allclose(np.asarray(v_b), np.asarray(v_a),
                               rtol=0, atol=1e-9)
    # momentum preserved by the impulse structure
    p_before = np.sum(np.asarray(m)[:, None] * np.asarray(v_unc), axis=0)
    p_after = np.sum(np.asarray(m)[:, None] * np.asarray(v_b), axis=0)
    np.testing.assert_allclose(p_after, p_before, rtol=1e-12)


def test_general_constraints_chain_topology():
    """A serial chain of shared-atom constraints (the coupling pattern the
    3-site closed form cannot express): projection restores every length,
    velocity projection zeroes every bond-direction relative velocity."""
    from chargeflux_tpu.constraints import (DistanceConstraints,
                                            constraint_residuals)

    rng = np.random.default_rng(7)
    n = 12
    x0 = np.cumsum(rng.normal(0, 1, (n, 3)), axis=0)
    x0 /= 1.0
    # constrain consecutive beads at their CURRENT lengths
    pairs = [(i, i + 1) for i in range(n - 1)]
    lengths = [float(np.linalg.norm(x0[i + 1] - x0[i])) for i in range(n - 1)]
    masses = rng.uniform(1.0, 16.0, n)
    gen = DistanceConstraints.create(pairs, lengths, masses)
    x0 = jnp.asarray(x0)
    x_unc = x0 + jnp.asarray(rng.normal(0, 0.02, (n, 3)))
    x_new = project_positions(x0, x_unc, gen)
    res = np.asarray(constraint_residuals(x_new, gen))
    assert np.max(np.abs(res)) < 1e-10
    v_unc = jnp.asarray(rng.normal(0, 1.0, (n, 3)))
    v = project_velocities(x_new, v_unc, gen)
    d = np.asarray(x_new)[1:] - np.asarray(x_new)[:-1]
    dv = np.asarray(v)[1:] - np.asarray(v)[:-1]
    assert np.max(np.abs(np.sum(d * dv, axis=-1))) < 1e-9


def test_general_constraints_poison_on_nonconvergence():
    """An unreachable projection (reference bond perpendicular to the
    violated direction makes the SHAKE linearization singular) must
    NaN-poison, never silently approximate."""
    from chargeflux_tpu.constraints import DistanceConstraints

    gen = DistanceConstraints.create([(0, 1)], [1.0], [1.0, 1.0], n_iter=8)
    x_old = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    # unconstrained move puts the bond PERPENDICULAR to the old direction
    x_unc = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    x_new = project_positions(x_old, x_unc, gen)
    assert np.all(np.isnan(np.asarray(x_new)[..., :]))


def test_general_constraints_drive_rattle_integrators():
    """DistanceConstraints plugs into the same constraints= slot as the
    rigid-water template: a constrained NVE trajectory holds every bond
    and conserves energy at the constrained-dynamics scale."""
    from chargeflux_tpu.constraints import (DistanceConstraints,
                                            constraint_residuals)

    _force, x, m, _box, params = _setup()
    force = _force
    gen = _general_from_rigid(params, m)
    force.setCutoffDistance(0.3)   # box/2 bound for the dense min-image sum
    e_fn = make_energy_fn(force.create_system(box=_box, dtype=jnp.float64))
    (x1, _v1, _f1, _e1), etot = rattle_nve_trajectory(
        x, jnp.zeros_like(x), e_fn, m, dt=2e-4, n_steps=20, params=gen)
    assert np.all(np.isfinite(np.asarray(etot)))
    res = np.asarray(constraint_residuals(x1, gen))
    assert np.max(np.abs(res)) < 1e-9
    drift = np.max(np.abs(np.asarray(etot) - float(etot[0])))
    assert drift < 0.5    # kJ/mol over 20 x 0.2 fs steps (lattice start)
