"""Two-level (replica x space) composition (parallel/multislice.py).

Validated on a 2x4 virtual mesh: replicas sharded over the "slice" axis,
per-replica work sharded over "space" (halo path when the grid divides it);
equality vs the single-device engine, grads included.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from chargeflux_tpu.energy import _energy
from chargeflux_tpu.models import water_box
from chargeflux_tpu.parallel import (ensemble_mean,
                                     make_multislice_energy_fn, shard_batch)


def test_multislice_replica_energies_match():
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=51)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    assert system.spec.cell_grid[0] % 4 == 0
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("slice", "space"))
    rng = np.random.default_rng(0)
    batch = jnp.asarray(np.stack(
        [pos + 0.005 * rng.standard_normal(pos.shape) for _ in range(4)]))
    xb = shard_batch(batch, mesh)
    e_fn = make_multislice_energy_fn(system, mesh)
    es = e_fn(xb)
    e_ref = np.array([float(_energy(batch[r], system)) for r in range(4)])
    np.testing.assert_allclose(np.asarray(es), e_ref, rtol=1e-12)

    mean = float(ensemble_mean(es, mesh))
    np.testing.assert_allclose(mean, e_ref.mean(), rtol=1e-12)

    # grads flow through the slice x space composition
    g = jax.grad(lambda xb: jnp.sum(e_fn(xb)))(xb)
    g_ref = jax.grad(lambda x: _energy(x, system))(batch[0])
    np.testing.assert_allclose(np.asarray(g)[0], np.asarray(g_ref),
                               rtol=1e-9, atol=1e-11)
