"""Replica-ensemble parallelism (the DP analog for MD).

vmap over a leading replica axis, sharded across a mesh axis with
jax.sharding — replicas are independent, so XLA partitions them with zero
communication.  The reference has no equivalent (single context, single
device); this is the SURVEY §2 "vmap replica ensembles" component.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..energy import _energy
from ..integrate import MDState, nve_step


@jax.jit
def replica_energy_and_forces(positions_batch, system):
    """[R, N, 3] -> ([R], [R, N, 3]) batched energies/forces."""

    def ef(x):
        e, g = jax.value_and_grad(_energy)(x, system)
        return e, -g

    return jax.vmap(ef, in_axes=(0,))(positions_batch)


def shard_replicas(positions_batch, mesh: Mesh, axis_name: str = "replica"):
    """Place a [R, ...] batch with the replica axis sharded over the mesh."""
    return jax.device_put(positions_batch,
                          NamedSharding(mesh, P(axis_name)))


def replica_nve_step(states: MDState, energy_fn, masses, dt: float) -> MDState:
    """One NVE step vmapped over a leading replica axis of every MDState
    leaf.  Jit + sharded inputs => each device integrates its replicas."""
    return jax.vmap(lambda s: nve_step(s, energy_fn, masses, dt))(states)


def remd_langevin_trajectory(states: MDState, energy_fn, masses, dt: float,
                             temperatures, friction: float, key,
                             n_steps: int, exchange_every: int = 10):
    """Temperature replica exchange (parallel tempering) — BAOAB Langevin
    vmapped over replicas at per-slot temperatures, with a Metropolis
    configuration-swap sweep between neighboring temperature slots every
    ``exchange_every`` steps, all inside one lax.scan program.

    The reference has no ensemble machinery at all (single context); the
    OpenMM-ecosystem analog is openmmtools' ReplicaExchangeSampler, which
    round-trips through the host per swap — here the entire REMD loop is
    one compiled program (swap sweeps are a [R]-permutation gather, ~free
    next to the force work).

    Mechanics (standard temperature-REMD):
    - slots keep their temperatures; CONFIGURATIONS migrate.  A swap of
      neighbor slots (i, j) is accepted with min(1, exp((bi-bj)(Ei-Ej)))
      where b = 1/kT and E the potential — detailed balance for the
      product ensemble.
    - sweeps alternate even/odd neighbor pairings (deterministic
      even-odd scheme) so configurations can traverse the ladder.
    - velocities travel with the configuration, rescaled by
      sqrt(T_dest/T_src) so the arriving kinetic energy matches the
      destination ensemble; forces and potential travel as-is (they are
      functions of the configuration only).

    ``states`` is an MDState batch with leading replica axis [R, ...];
    ``temperatures`` a length-R ladder (ascending by convention).
    Returns (final MDState batch, [n_sweeps, R] per-slot potentials
    sampled at each sweep, [n_sweeps, R//2] per-sweep swap-acceptance
    indicators) — the acceptance trace is the tuning observable (aim
    ~20-40% per pair).
    """
    from ..integrate import baoab_coeffs, baoab_pre_force
    from ..units import BOLTZ

    if n_steps % exchange_every or n_steps <= 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "exchange_every")
    r, n, _ = states.positions.shape
    temps = jnp.asarray(temperatures, states.positions.dtype)
    if temps.shape != (r,):
        raise ValueError(f"need {r} temperatures, got {temps.shape}")
    betas = 1.0 / (BOLTZ * temps)
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    # c1 depends only on (friction, dt); c2 carries the per-slot sqrt(kT)
    c1, _ = baoab_coeffs(dt, friction, 1.0, states.positions.dtype)
    c2_r = jax.vmap(lambda t: baoab_coeffs(dt, friction, t,
                                           states.positions.dtype)[1])(temps)

    def one_step(pf, e0, c2, kk):
        x, v = baoab_pre_force(pf[:, 0:3], pf[:, 3:6], pf[:, 6:9],
                               inv_m, dt, c1, c2, kk)
        e, g = jax.value_and_grad(energy_fn)(x)
        f = -g
        v = v + 0.5 * dt * f * inv_m
        return jnp.concatenate([x, v, f], axis=1), e

    def md_chunk(p, pot, key):
        def body(carry, keys):
            p, pot = carry
            p, pot = jax.vmap(one_step)(p.reshape(r, n, 9), pot, c2_r,
                                        keys)
            return (p.reshape(r, n * 9), pot), None

        keys = jax.random.split(key, (exchange_every, r))
        (p, pot), _ = jax.lax.scan(body, (p, pot), keys)
        return p, pot

    # even-odd neighbor pairings: parity 0 pairs (0,1)(2,3)...,
    # parity 1 pairs (1,2)(3,4)....  Static index tables padded to a
    # common length with the self-pair (0, 0) + valid=False: a slot must
    # appear in at most ONE attempted pair per sweep or the swap map
    # stops being a permutation, and slot 0 is unpaired exactly when
    # parity-1 needs padding (even r), so its identity writes are safe
    n_pairs = max(r // 2, 1)

    def pairing(start):
        lo = list(range(start, r - 1, 2))
        pad = n_pairs - len(lo)
        valid = [True] * len(lo) + [False] * pad
        hi = [i + 1 for i in lo] + [0] * pad
        lo = lo + [0] * pad
        return jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid)

    lo0, hi0, valid0 = pairing(0)
    lo1, hi1, valid1 = pairing(1)

    def exchange(p, pot, parity, key):
        lo = jnp.where(parity == 0, lo0, lo1)
        hi = jnp.where(parity == 0, hi0, hi1)
        valid = jnp.where(parity == 0, valid0, valid1)
        delta = (betas[lo] - betas[hi]) * (pot[lo] - pot[hi])
        u = jax.random.uniform(key, (n_pairs,), pot.dtype)
        accept = (jnp.log(u) < delta) & valid
        # permutation: slot -> source slot of the configuration it receives
        perm = jnp.arange(r)
        perm = perm.at[lo].set(jnp.where(accept, hi, lo))
        perm = perm.at[hi].set(jnp.where(accept, lo, hi))
        p = p[perm].reshape(r, n, 9)
        # arriving velocities rescaled to the destination temperature
        vscale = jnp.sqrt(temps / temps[perm])[:, None, None]
        p = p.at[:, :, 3:6].multiply(vscale)
        return p.reshape(r, n * 9), pot[perm], accept

    def sweep(carry, sweep_idx):
        p, pot, k = carry
        k, k_md, k_ex = jax.random.split(k, 3)
        p, pot = md_chunk(p, pot, k_md)
        p, pot, accept = exchange(p, pot, sweep_idx % 2, k_ex)
        return (p, pot, k), (pot, accept)

    p0 = jnp.concatenate(
        [states.positions, states.velocities, states.forces],
        axis=2).reshape(r, n * 9)
    (p, pot, _), (pots, accepts) = jax.lax.scan(
        sweep, (p0, states.potential, key),
        jnp.arange(n_steps // exchange_every))
    p = p.reshape(r, n, 9)
    final = MDState(p[:, :, 0:3], p[:, :, 3:6], p[:, :, 6:9], pot)
    return final, pots, accepts


def replica_nve_trajectory(states: MDState, energy_fn, masses, dt: float,
                           n_steps: int):
    """n_steps of NVE vmapped over a leading replica axis; returns
    (final MDState batch, [n_steps, R] per-step total energies).

    The scan carries ONE flat ``[R, N*9]`` array (x|v|f packed per replica,
    then flattened): a ``[R, N, 3]``-shaped carry may pay the same
    narrow-minor-dim relayout at the loop boundary as the single-system
    integrators' separate [N, 3] carries."""
    from ..integrate import kinetic_energy

    r, n, _ = states.positions.shape

    def body(carry, _):
        p, pot = carry

        def one(pf, e0):
            s = MDState(pf[:, 0:3], pf[:, 3:6], pf[:, 6:9], e0)
            s = nve_step(s, energy_fn, masses, dt)
            e_tot = s.potential + kinetic_energy(s.velocities, masses)
            return jnp.concatenate(
                [s.positions, s.velocities, s.forces], axis=1), \
                s.potential, e_tot

        p, pot, e_tot = jax.vmap(
            lambda pf, e0: one(pf.reshape(n, 9), e0))(p, pot)
        return (p.reshape(r, n * 9), pot), e_tot

    p0 = jnp.concatenate(
        [states.positions, states.velocities, states.forces],
        axis=2).reshape(r, n * 9)
    (p, pot), es = jax.lax.scan(body, (p0, states.potential), None,
                                length=n_steps)
    p = p.reshape(r, n, 9)
    return MDState(p[:, :, 0:3], p[:, :, 3:6], p[:, :, 6:9], pot), es
