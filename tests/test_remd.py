"""Temperature replica exchange (parallel tempering): permutation
integrity of the swap sweeps, detailed-balance statistics (per-slot
equipartition with exchanges on), degenerate-ladder acceptance."""

import jax
import jax.numpy as jnp
import numpy as np

from chargeflux_tpu.integrate import MDState
from chargeflux_tpu.parallel import remd_langevin_trajectory
from chargeflux_tpu.units import BOLTZ

K_SPRING = 1000.0  # kJ/mol/nm^2


def _harmonic(x):
    return 0.5 * K_SPRING * jnp.sum(x * x)


def _init_states(key, r, n=1, spread=0.05, dtype=jnp.float64):
    x = spread * jax.random.normal(key, (r, n, 3), dtype)
    f = -jax.vmap(jax.grad(_harmonic))(x)
    pot = jax.vmap(_harmonic)(x)
    return MDState(x, jnp.zeros_like(x), f, pot)


def test_remd_swaps_are_a_permutation():
    """With dt = 0 the MD chunks are the identity (BAOAB c1=1, c2=0), so
    only the exchange sweeps act: the multiset of configurations must be
    exactly preserved — any pairing-table bug (overlapping pairs, dummy
    pads) duplicates or loses a configuration."""
    r = 4
    states = _init_states(jax.random.PRNGKey(0), r)
    m = jnp.ones((1,), jnp.float64)
    temps = [100.0, 150.0, 225.0, 340.0]
    final, pots, accepts = remd_langevin_trajectory(
        states, _harmonic, m, dt=0.0, temperatures=temps, friction=1.0,
        key=jax.random.PRNGKey(3), n_steps=40, exchange_every=2)
    # both parities exercised, and at least one swap must have fired
    assert np.asarray(accepts).any()
    before = np.sort(np.asarray(states.positions).reshape(r, -1), axis=0)
    after = np.sort(np.asarray(final.positions).reshape(r, -1), axis=0)
    np.testing.assert_array_equal(before, after)
    # potentials travel with their configurations
    np.testing.assert_allclose(
        np.sort(np.asarray(final.potential)),
        np.sort(np.asarray(states.potential)), rtol=1e-12)


def test_remd_equipartition_per_slot():
    """Each temperature SLOT must sample its own canonical ensemble even
    while configurations migrate: 3D harmonic well => <PE> = (3/2) kT per
    slot.  This is the detailed-balance check — a sign error in the
    Metropolis rule or a missing velocity rescale skews the slot
    averages."""
    r = 4
    temps = np.array([100.0, 180.0, 320.0, 580.0])
    states = _init_states(jax.random.PRNGKey(1), r)
    m = jnp.ones((1,), jnp.float64)
    final, pots, accepts = remd_langevin_trajectory(
        states, _harmonic, m, dt=2e-3, temperatures=temps, friction=20.0,
        key=jax.random.PRNGKey(7), n_steps=30000, exchange_every=10)
    pots = np.asarray(pots)              # [sweeps, R]
    mean_pe = pots[len(pots) // 3:].mean(axis=0)
    expect = 1.5 * BOLTZ * temps
    # exchanges must actually mix...
    acc = np.asarray(accepts).mean()
    assert 0.05 < acc < 1.0
    # ...and every slot still matches its own ensemble
    np.testing.assert_allclose(mean_pe, expect, rtol=0.15)


def test_remd_equal_temperatures_accept_everything():
    """A flat ladder has delta = 0 for every pair: all valid swap
    attempts accept (log u < 0 almost surely)."""
    r = 4
    states = _init_states(jax.random.PRNGKey(2), r)
    m = jnp.ones((1,), jnp.float64)
    final, _pots, accepts = remd_langevin_trajectory(
        states, _harmonic, m, dt=1e-3, temperatures=[200.0] * r,
        friction=10.0, key=jax.random.PRNGKey(5), n_steps=40,
        exchange_every=2)
    accepts = np.asarray(accepts)        # [sweeps, n_pairs]
    # parity-0 sweeps have 2 valid pairs, parity-1 sweeps 1 valid + 1 dummy
    assert accepts[0::2].all()
    assert accepts[1::2, 0].all()
    assert not accepts[1::2, 1].any()    # the masked dummy never fires


def test_remd_sharded_replicas_match_single_device():
    """REMD under a replica-sharded mesh must equal the unsharded run
    bitwise-to-tolerance: the swap sweep's [R]-permutation gather crosses
    device boundaries (a configuration migrating between temperature
    slots = a cross-device copy on real hardware)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    r = 8
    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("replica",))
    temps = list(100.0 * 1.35 ** np.arange(r))
    states = _init_states(jax.random.PRNGKey(4), r)
    m = jnp.ones((1,), jnp.float64)
    kw = dict(dt=1e-3, temperatures=temps, friction=10.0,
              key=jax.random.PRNGKey(11), n_steps=60, exchange_every=5)

    ref, pots_ref, acc_ref = remd_langevin_trajectory(states, _harmonic, m,
                                                      **kw)

    sh = NamedSharding(mesh, P("replica"))
    states_sh = MDState(*(jax.device_put(leaf, sh) for leaf in states))
    res, pots, acc = remd_langevin_trajectory(states_sh, _harmonic, m, **kw)

    np.testing.assert_allclose(np.asarray(res.positions),
                               np.asarray(ref.positions),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(acc_ref))
    np.testing.assert_allclose(np.asarray(pots), np.asarray(pots_ref),
                               rtol=1e-12, atol=1e-14)
