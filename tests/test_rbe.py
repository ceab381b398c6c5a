"""Random batch Ewald (rbe.py) — stochastic reciprocal estimator.

Contract: the estimator is UNBIASED against the classical k-space sum
(ewald.reciprocal_energy with a generous kmax) in energy AND forces,
its variance shrinks as 1/p, and the Langevin driver runs stable NVT
with a fresh draw per step.
"""

import numpy as np

import jax
import jax.numpy as jnp

from chargeflux_tpu.charges import effective_charges
from chargeflux_tpu.ewald import reciprocal_energy
from chargeflux_tpu.models import water_box
from chargeflux_tpu.rbe import (rbe_reciprocal_energy, rbe_tables,
                                sample_kvecs)


def _setup():
    force, pos, masses, box = water_box(n_side=3, flux="bond_angle",
                                        cutoff=0.42, seed=5)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 recip_method="xla")
    x = jnp.asarray(pos)
    q = effective_charges(x, system)
    return system, x, q, np.asarray(box), masses


def test_energy_unbiased():
    system, x, q, box, _ = _setup()
    spec = system.spec
    # converged classical reference (generous kmax)
    kmax = tuple(k + 6 for k in spec.kmax)
    e_ref = float(reciprocal_energy(x, q, system.box, spec.alpha, kmax))
    tables = rbe_tables(box, spec.alpha)
    p = 64
    est = jax.jit(lambda k: rbe_reciprocal_energy(x, q, tables, p, k))
    draws = np.array([float(est(jax.random.PRNGKey(i)))
                      for i in range(300)])
    mean = draws.mean()
    stderr = draws.std(ddof=1) / np.sqrt(len(draws))
    assert abs(mean - e_ref) < 4.0 * stderr + 1e-10 * abs(e_ref), (
        mean, e_ref, stderr)
    # the estimator genuinely fluctuates (it is a random batch)
    assert draws.std() > 1e-6 * abs(e_ref)


def test_variance_shrinks_with_batch():
    system, x, q, box, _ = _setup()
    tables = rbe_tables(box, system.spec.alpha)

    def std_at(p, n=150):
        est = jax.jit(lambda k: rbe_reciprocal_energy(x, q, tables, p, k))
        d = np.array([float(est(jax.random.PRNGKey(1000 + i)))
                      for i in range(n)])
        return d.std(ddof=1)

    s16, s256 = std_at(16), std_at(256)
    # var ~ 1/p: std ratio should be ~4 (allow wide sampling slack)
    assert 2.0 < s16 / s256 < 8.0, (s16, s256)


def test_forces_unbiased():
    system, x, q, box, _ = _setup()
    spec = system.spec
    kmax = tuple(k + 6 for k in spec.kmax)
    f_ref = np.asarray(-jax.grad(
        lambda xx: reciprocal_energy(
            xx, effective_charges(xx, system), system.box, spec.alpha,
            kmax))(x))
    tables = rbe_tables(box, spec.alpha)
    p = 64
    gfn = jax.jit(jax.grad(lambda xx, k: rbe_reciprocal_energy(
        xx, effective_charges(xx, system), tables, p, k)))
    n_draws = 200
    acc = np.zeros_like(f_ref)
    sq = np.zeros_like(f_ref)
    for i in range(n_draws):
        g = -np.asarray(gfn(x, jax.random.PRNGKey(7000 + i)))
        acc += g
        sq += g * g
    mean = acc / n_draws
    std = np.sqrt(np.maximum(sq / n_draws - mean ** 2, 0.0))
    stderr = std / np.sqrt(n_draws)
    # componentwise z-scores: the mean force must sit on the reference
    # within its own sampling error (bias test, not a noise-floor test —
    # the residual RMSE of a 200-draw mean IS the stderr)
    z = np.abs(mean - f_ref) / (stderr + 1e-12)
    assert np.percentile(z, 95) < 3.0, np.percentile(z, 95)
    rmse = np.sqrt(np.mean((mean - f_ref) ** 2))
    noise_floor = np.sqrt(np.mean(stderr ** 2))
    assert rmse < 2.0 * noise_floor, (rmse, noise_floor)


def test_langevin_driver_stable():
    from chargeflux_tpu.integrate import (init_state_nb,
                                          maxwell_velocities)
    from chargeflux_tpu.models import water_bonded_params
    from chargeflux_tpu.rbe import (make_rbe_nb_energy_fn,
                                    rbe_langevin_trajectory_nb)

    force, pos, masses, box = water_box(n_side=3, flux="bond_angle",
                                        cutoff=0.42, seed=5)
    system = force.create_system(box=box, dtype=jnp.float64)
    bonded = water_bonded_params(27, box=box, dtype=jnp.float64)
    m = jnp.asarray(np.asarray(masses), jnp.float64)
    e_fn, init_nb = make_rbe_nb_energy_fn(system, n_samples=64,
                                          bonded=bonded)
    x = jnp.asarray(pos)
    v0 = maxwell_velocities(m, 300.0, jax.random.PRNGKey(1))
    nb = init_nb(x)
    e0, f0, nb = e_fn(x, nb, jax.random.PRNGKey(2))
    from chargeflux_tpu.integrate import MDStateNB
    s0 = MDStateNB(x, v0, f0, e0, nb)
    s1, kes = rbe_langevin_trajectory_nb(
        s0, e_fn, init_nb, m, dt=2e-4, temperature=300.0, friction=5.0,
        key=jax.random.PRNGKey(3), n_steps=60, rebuild_every=10)
    assert np.all(np.isfinite(np.asarray(kes)))
    assert np.all(np.isfinite(np.asarray(s1.positions)))


def test_zero_vector_masked():
    """The sampler keeps the zero triple in the product distribution; the
    estimator must mask it (its 1/k^2 would be inf)."""
    system, x, q, box, _ = _setup()
    tables = rbe_tables(box, system.spec.alpha)
    # scan keys until a draw contains the zero vector, then evaluate
    for i in range(500):
        k, k2, nonzero = sample_kvecs(tables, 64, jax.random.PRNGKey(i),
                                      jnp.float64)
        if not bool(jnp.all(nonzero)):
            e = float(rbe_reciprocal_energy(x, q, tables, 64,
                                            jax.random.PRNGKey(i)))
            assert np.isfinite(e)
            return
    # zero draws are ~1/1900 per sample; 500*64 draws without one would be
    # astronomically unlikely — treat as a sampler bug
    raise AssertionError("no zero-vector draw in 32k samples")
