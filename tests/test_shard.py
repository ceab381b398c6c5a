"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY §4.5).

Sharded-vs-single-device equality for energy and forces, for every direct
path (noPBC dense, PBC dense, PBC cell list), plus replica ensembles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import chargeflux_tpu as cf
from chargeflux_tpu.parallel import (
    make_sharded_energy_and_forces_fn,
    make_sharded_energy_fn,
    replica_energy_and_forces,
    shard_replicas,
)
from chargeflux_tpu.models import water_box, water_cluster


def _mesh(n=8, name="space"):
    devs = jax.devices()
    assert len(devs) >= n, "conftest must force 8 virtual CPU devices"
    return Mesh(np.array(devs[:n]), (name,))


def _cases():
    force, pos, _ = water_cluster(n_side=2, flux="bond_angle", seed=31)
    yield force.create_system(dtype=jnp.float64), jnp.asarray(pos), "nopbc-dense"
    force, pos, _, box = water_box(n_side=2, flux="water", seed=32)
    yield (force.create_system(box=box, dtype=jnp.float64), jnp.asarray(pos),
           "pbc-dense")
    force, pos, _, box = water_box(n_side=4, flux="bond_angle", cutoff=0.62,
                                   density_spacing=0.62, seed=33)
    yield (force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell"), jnp.asarray(pos),
           "pbc-cell")


def test_sharded_energy_matches_single_device():
    mesh = _mesh()
    for system, x, tag in _cases():
        e_ref = float(cf.energy(x, system))
        e_sh = float(make_sharded_energy_fn(system, mesh)(x))
        comps = cf.energy_components(x, system)
        scale = max(max(abs(float(v)) for v in comps.values()), 1.0)
        assert abs(e_sh - e_ref) <= 1e-12 * scale, tag


def test_sharded_forces_match_single_device():
    mesh = _mesh()
    for system, x, tag in _cases():
        f_ref = np.asarray(cf.forces(x, system))
        e, f_sh = make_sharded_energy_and_forces_fn(system, mesh)(x)
        scale = np.abs(f_ref).max()
        np.testing.assert_allclose(np.asarray(f_sh) / scale, f_ref / scale,
                                   atol=1e-11, err_msg=tag)


def test_sharded_uneven_work_division():
    """81 atoms / 27 exclusions / flux terms not divisible by 8 devices —
    padding must not change results."""
    mesh = _mesh()
    force, pos, _, box = water_box(n_side=3, flux="bond_angle", seed=34)
    system = force.create_system(box=box, dtype=jnp.float64)
    x = jnp.asarray(pos)
    e_ref = float(cf.energy(x, system))
    e_sh = float(make_sharded_energy_fn(system, mesh)(x))
    comps = cf.energy_components(x, system)
    scale = max(max(abs(float(v)) for v in comps.values()), 1.0)
    assert abs(e_sh - e_ref) <= 1e-12 * scale


def test_2d_mesh_replica_times_space():
    """DP x spatial composition on a (replica=2, space=4) mesh: batched
    energies must match the single-device engine per replica."""
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("replica", "space"))
    force, pos, _, box = water_box(n_side=2, flux="bond_angle", seed=36)
    system = force.create_system(box=box, dtype=jnp.float64)
    from chargeflux_tpu.parallel import make_replica_sharded_energy_fn

    e_batch_fn = make_replica_sharded_energy_fn(system, mesh)
    rng = np.random.default_rng(1)
    batch = jnp.asarray(np.stack([pos + 0.01 * rng.standard_normal(pos.shape)
                                  for _ in range(4)]))
    es = e_batch_fn(batch)
    comps = cf.energy_components(batch[0], system)
    scale = max(max(abs(float(v)) for v in comps.values()), 1.0)
    for r in range(4):
        e_ref = float(cf.energy(batch[r], system))
        assert abs(float(es[r]) - e_ref) <= 1e-12 * scale, r


def test_replica_ensemble_matches_loop():
    mesh = _mesh(name="replica")
    force, pos, _ = water_cluster(n_side=2, flux="bond_angle", seed=35)
    system = force.create_system(dtype=jnp.float64)
    rng = np.random.default_rng(0)
    batch = np.stack([pos + 0.01 * rng.standard_normal(pos.shape)
                      for _ in range(16)])
    xb = shard_replicas(jnp.asarray(batch), mesh)
    es, fs = replica_energy_and_forces(xb, system)
    for r in [0, 7, 15]:
        e_ref, f_ref = cf.energy_and_forces(jnp.asarray(batch[r]), system)
        assert float(es[r]) == pytest.approx(float(e_ref), rel=1e-12)
        np.testing.assert_allclose(np.asarray(fs[r]), np.asarray(f_ref),
                                   rtol=1e-10, atol=1e-10)


def test_replica_nve_trajectory_matches_stepwise():
    """The flat [R, N*9]-carry ensemble trajectory (the perf layout) must
    be a pure layout change: identical physics
    to vmapped stepwise replica_nve_step."""
    from chargeflux_tpu.integrate import init_state, make_energy_fn
    from chargeflux_tpu.parallel.replicas import (
        replica_nve_step,
        replica_nve_trajectory,
    )

    force, pos, masses = water_cluster(n_side=2, flux="bond_angle", seed=36)
    system = force.create_system(dtype=jnp.float64)
    e_fn = make_energy_fn(system)
    rng = np.random.default_rng(2)
    batch = jnp.asarray(np.stack(
        [pos + 0.01 * rng.standard_normal(pos.shape) for _ in range(4)]))
    masses = jnp.asarray(masses)
    v0 = jnp.zeros_like(batch)
    dt = 5e-5

    states = jax.vmap(lambda x, v: init_state(x, v, e_fn))(batch, v0)
    s_ref = states
    for _ in range(5):
        s_ref = replica_nve_step(s_ref, e_fn, masses, dt)

    final, es = replica_nve_trajectory(states, e_fn, masses, dt, 5)
    assert es.shape == (5, 4)
    np.testing.assert_allclose(np.asarray(final.positions),
                               np.asarray(s_ref.positions), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(final.velocities),
                               np.asarray(s_ref.velocities), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(final.potential),
                               np.asarray(s_ref.potential), rtol=1e-10)
