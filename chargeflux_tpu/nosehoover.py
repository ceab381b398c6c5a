"""Nose-Hoover chain (NHC) thermostat — deterministic NVT.

The reference delegates integration to OpenMM (SURVEY §1 L0), whose
integrator family includes ``NoseHooverIntegrator``; this is the engine's
L0-replacement analog, complementing the stochastic BAOAB Langevin driver
(integrate.py) with a *deterministic*, time-reversible thermostat whose
extended-system energy is exactly conserved — the strongest NVT
correctness check available (tests pin it).

Algorithm: Martyna-Tuckerman-Klein chains with a Suzuki-Yoshida-factored
half-step applied around a velocity-Verlet core (the textbook NHC-VV
splitting).  The chain is tiny (length 3 by default) so its update is a
statically unrolled scalar recurrence — negligible next to the force
evaluation; everything runs under jit/lax.scan like the other drivers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .integrate import MDState, kinetic_energy, x_into_energy
from .units import BOLTZ

# third-order Suzuki-Yoshida composition weights (w1, 1 - 2*w1, w1)
_SY1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_SY3 = (_SY1, 1.0 - 2.0 * _SY1, _SY1)


class NHChain(NamedTuple):
    xi: jax.Array     # [M] chain "positions" (enter only the conserved qty)
    v_xi: jax.Array   # [M] chain velocities, 1/ps
    q: jax.Array      # [M] chain masses, kJ/mol*ps^2


def nhc_init(n_dof: int, temperature: float, tau: float,
             chain_length: int = 3, dtype=jnp.float32) -> NHChain:
    """Chain at rest with the standard MTK masses Q1 = n_dof*kT*tau^2,
    Qk = kT*tau^2 (tau = coupling period, ps; ~20-50 dt is typical)."""
    if chain_length < 2:
        raise ValueError("chain_length must be >= 2")
    kt = BOLTZ * temperature
    q = jnp.full((chain_length,), kt * tau * tau, dtype)
    q = q.at[0].mul(float(n_dof))
    z = jnp.zeros((chain_length,), dtype)
    return NHChain(z, z, q)


def _nhc_half(chain: NHChain, ke2, n_dof: int, kt: float, dt_half: float,
              n_sy: int = 3):
    """One NHC update of duration ``dt_half`` acting on a system with
    current 2*KE = ``ke2``; returns (velocity scale factor, new chain).
    Statically unrolled over the Suzuki-Yoshida weights and the chain."""
    xi, v_xi, q = chain
    m = q.shape[0]
    weights = _SY3 if n_sy == 3 else (1.0,)
    scale = jnp.asarray(1.0, ke2.dtype)

    def g(k, ke2_now):
        if k == 0:
            return (ke2_now - n_dof * kt) / q[0]
        return (q[k - 1] * v_xi[k - 1] * v_xi[k - 1] - kt) / q[k]

    for w in weights:
        wdt = w * dt_half
        # down sweep: thermostat the thermostats from the tail in
        v_xi = v_xi.at[m - 1].add(0.25 * wdt * g(m - 1, ke2))
        for k in range(m - 2, -1, -1):
            aa = jnp.exp(-0.125 * wdt * v_xi[k + 1])
            v_xi = v_xi.at[k].set(v_xi[k] * aa * aa
                                  + 0.25 * wdt * g(k, ke2) * aa)
        # scale the particle velocities
        s = jnp.exp(-0.5 * wdt * v_xi[0])
        scale = scale * s
        ke2 = ke2 * s * s
        xi = xi + 0.5 * wdt * v_xi
        # up sweep (mirror)
        for k in range(m - 1):
            aa = jnp.exp(-0.125 * wdt * v_xi[k + 1])
            v_xi = v_xi.at[k].set(v_xi[k] * aa * aa
                                  + 0.25 * wdt * g(k, ke2) * aa)
        v_xi = v_xi.at[m - 1].add(0.25 * wdt * g(m - 1, ke2))
    return scale, NHChain(xi, v_xi, q)


def nhc_conserved(state: MDState, chain: NHChain, masses, n_dof: int,
                  temperature: float):
    """The NHC extended-system invariant H' = KE + PE + sum_k Qk v_xik^2/2
    + n_dof*kT*xi_1 + kT*sum_{k>=2} xi_k — exactly conserved by the ideal
    dynamics; its drift measures integrator error (the NVT analog of NVE
    energy drift)."""
    kt = BOLTZ * temperature
    bath = (0.5 * jnp.sum(chain.q * chain.v_xi * chain.v_xi)
            + n_dof * kt * chain.xi[0] + kt * jnp.sum(chain.xi[1:]))
    return (kinetic_energy(state.velocities, masses) + state.potential
            + bath)


def nose_hoover_step(state: MDState, chain: NHChain, energy_fn, masses,
                     dt: float, temperature: float, n_dof: int):
    """One NHC-VV step: half chain update, velocity-Verlet, half chain."""
    kt = BOLTZ * temperature
    inv_m = (1.0 / masses)[:, None]
    v = state.velocities
    s1, chain = _nhc_half(chain, 2.0 * kinetic_energy(v, masses), n_dof,
                          kt, 0.5 * dt)
    v = v * s1
    v_half = v + 0.5 * dt * state.forces * inv_m
    x = state.positions + dt * v_half
    e, grad = jax.value_and_grad(energy_fn)(x)
    f = -grad
    v = v_half + 0.5 * dt * f * inv_m
    s2, chain = _nhc_half(chain, 2.0 * kinetic_energy(v, masses), n_dof,
                          kt, 0.5 * dt)
    return MDState(x, v * s2, f, e), chain


def nose_hoover_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                              temperature: float, tau: float, n_steps: int,
                              rebuild_every: int = 10, chain_length: int = 3,
                              n_dof: int | None = None,
                              chain: NHChain | None = None):
    """Production-scale deterministic NVT: NHC-VV with the neighbor state
    rebuilt every ``rebuild_every`` steps — the Nose-Hoover analog of
    integrate.langevin_trajectory_nb (same packed [N, 9] carry, same
    unconditional nested-scan rebuild and freshness guard via ``e_fn``).
    ``state`` is an integrate.MDStateNB; returns (final_state, final_chain,
    per-step kinetic energies).  Exactly resumable: pass the returned
    chain back in (no key bookkeeping — the thermostat is
    deterministic)."""
    from .integrate import MDStateNB

    if n_steps % rebuild_every or n_steps <= 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    n = state.positions.shape[0]
    if n_dof is None:
        n_dof = 3 * n - 3
    if chain is None:
        chain = nhc_init(n_dof, temperature, tau, chain_length,
                         state.positions.dtype)
    kt = BOLTZ * temperature
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]

    def inner(nb):
        def body(carry, _):
            p, ch = carry
            x, v, f = p[:, 0:3], p[:, 3:6], p[:, 6:9]
            s1, ch = _nhc_half(ch, 2.0 * kinetic_energy(v, masses), n_dof,
                               kt, 0.5 * dt)
            v = v * s1
            v_half = v + 0.5 * dt * f * inv_m
            x = x + dt * v_half
            _e, f, _nb = e_fn(x_into_energy(x), nb)
            v = v_half + 0.5 * dt * f * inv_m
            s2, ch = _nhc_half(ch, 2.0 * kinetic_energy(v, masses), n_dof,
                               kt, 0.5 * dt)
            v = v * s2
            return ((jnp.concatenate([x, v, f], axis=1), ch),
                    kinetic_energy(v, masses))
        return body

    def outer(carry, _):
        p, ch = carry
        nb = init_nb(p[:, 0:3])
        (p, ch), kes = jax.lax.scan(inner(nb), (p, ch), None,
                                    length=rebuild_every)
        return (p, ch), kes

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, chain), kes = jax.lax.scan(outer, (p0, chain), None,
                                   length=n_steps // rebuild_every)
    x = p[:, 0:3]
    nb = init_nb(x)
    e_pot, _f, nb = e_fn(x, nb)
    final = MDStateNB(x, p[:, 3:6], p[:, 6:9], e_pot, nb)
    return final, chain, kes.reshape(-1)


def nose_hoover_trajectory(state: MDState, energy_fn, masses, dt: float,
                           temperature: float, tau: float, n_steps: int,
                           chain_length: int = 3, n_dof: int | None = None,
                           chain: NHChain | None = None):
    """n_steps of deterministic NHC NVT; returns (final_state, final_chain,
    per-step kinetic energies).  Same packed [N, 9] x|v|f scan carry as the
    other drivers (integrate.make_packed_nve_chunk).  ``n_dof`` defaults to 3N - 3 (the chain scales velocities
    uniformly, so zero total momentum is preserved and those 3 DoF carry
    no kinetic energy); pass 3N if momentum is not zeroed.  Resumable:
    pass the returned chain back in."""
    n = state.positions.shape[0]
    if n_dof is None:
        n_dof = 3 * n - 3
    if chain is None:
        chain = nhc_init(n_dof, temperature, tau, chain_length,
                         state.positions.dtype)

    def body(carry, _):
        p, ch = carry
        s = MDState(p[:, 0:3], p[:, 3:6], p[:, 6:9], 0.0)
        s, ch = nose_hoover_step(s, ch, energy_fn, masses, dt, temperature,
                                 n_dof)
        p = jnp.concatenate([s.positions, s.velocities, s.forces], axis=1)
        return (p, ch), kinetic_energy(s.velocities, masses)

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, chain), kes = jax.lax.scan(body, (p0, chain), None, length=n_steps)
    x = p[:, 0:3]
    final = MDState(x, p[:, 3:6], p[:, 6:9], energy_fn(x))
    return final, chain, kes
