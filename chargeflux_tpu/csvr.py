"""CSVR thermostat — canonical sampling through velocity rescaling
(Bussi, Donadio & Parrinello, J. Chem. Phys. 126, 014101 (2007)).

The third NVT family next to Langevin BAOAB (integrate.py) and
Nose-Hoover chains (nosehoover.py): one *global* stochastic rescale of
all velocities per step, exactly canonical in the kinetic energy,
leaving the Newtonian dynamics (and so dynamical observables like
diffusion and the flux-dipole IR spectra, utils/analysis.py) far less
perturbed than per-particle Langevin noise.  This is the ecosystem
default the reference plugin's users would reach for around it
(GROMACS ``v-rescale``; openmmtools exposes it too) — the reference
itself ships no integrators at all (SURVEY §1 L0).

Shape: the rescale is two scalar random draws + one
multiply of the packed velocity block per step — it composes with the
packed ``[N, 9]`` nb-reuse scan carry (integrate.make_packed_nve_chunk)
with no extra [N, 3] carries.  The chi-squared draw uses
``jax.random.gamma`` (chi2_k = 2 Gamma(k/2, 1)), traced once.

Conserved quantity: ``H_eff = E_pot + K - W`` where ``W`` accumulates
the kinetic energy the thermostat injected (sum of ``K' - K`` over
rescales) — drivers return the per-step ``W`` series so tests (and
users) can monitor the Bussi invariant exactly like an NVE energy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .integrate import MDStateNB, kinetic_energy, x_into_energy
from .units import BOLTZ


def csvr_scale(kin, n_dof: int, dt: float, tau: float, temperature: float,
               key, dtype):
    """One CSVR rescale factor: returns (alpha, dK) for current kinetic
    energy ``kin`` (Bussi 2007, Eq. A7).

    ``alpha^2 = c + (1-c) (kT/2K) (R1^2 + S) + 2 R1 sqrt(c (1-c) kT/2K)``
    with ``c = exp(-dt/tau)``, ``R1 ~ N(0,1)`` and
    ``S ~ chi^2_{n_dof - 1}``.  The positive root is used (the
    negative-alpha branch has ~exp(-K/kT) probability for condensed
    systems — unreachable at f64 and irrelevant to sampling).  ``kin``
    is guarded against 0 (a cold start cannot be heated by a
    multiplicative thermostat — initialize with maxwell_velocities).
    """
    c = jnp.asarray(jnp.exp(-dt / tau), dtype)
    kt_half = jnp.asarray(0.5 * BOLTZ * temperature, dtype)
    k1, k2 = jax.random.split(key)
    r1 = jax.random.normal(k1, dtype=dtype)
    s = 2.0 * jax.random.gamma(k2, jnp.asarray(0.5 * (n_dof - 1), dtype),
                               dtype=dtype)
    kin_safe = jnp.maximum(kin, jnp.asarray(1e-12, dtype))
    ratio = kt_half / kin_safe
    alpha2 = (c + (1.0 - c) * ratio * (r1 * r1 + s)
              + 2.0 * r1 * jnp.sqrt(c * (1.0 - c) * ratio))
    alpha = jnp.sqrt(alpha2)
    return alpha, (alpha2 - 1.0) * kin


def csvr_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses, dt: float,
                       temperature: float, tau: float, key, n_steps: int,
                       rebuild_every: int = 10, n_constraints: int = 0):
    """n_steps of velocity-Verlet + one global CSVR rescale per step, with
    the neighbor state rebuilt every ``rebuild_every`` steps (same packed
    ``[N, 9]`` carry / nested-scan amortization / freshness-guard contract
    as :func:`integrate.langevin_trajectory_nb`).

    Returns ``(final_state, diag)`` with ``diag = {"etot", "kinetic",
    "work"}`` [n_steps] series — total energy, kinetic energy (after the
    rescale) and cumulative thermostat work ``W``; ``etot - work`` is the
    Bussi conserved quantity (tests/test_csvr.py pins its drift).

    Exactly resumable: continue with
    ``advance_key(key, n_steps // rebuild_every)`` (one split per chunk,
    the same chain convention as the other nb drivers).
    """
    if n_steps % rebuild_every or n_steps == 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    masses = jnp.asarray(masses)
    dtype = state.positions.dtype
    n_dof = 3 * state.positions.shape[0] - n_constraints
    inv_m = (0.5 * dt / masses)[:, None]

    def inner(nb):
        def body(carry, kk):
            p, w = carry
            x, v, f = p[:, 0:3], p[:, 3:6], p[:, 6:9]
            v_half = v + f * inv_m
            x_new = x + dt * v_half
            e, f_new, _nb = e_fn(x_into_energy(x_new), nb)
            v_new = v_half + f_new * inv_m
            kin = kinetic_energy(v_new, masses)
            alpha, dk = csvr_scale(kin, n_dof, dt, tau, temperature, kk,
                                   dtype)
            v_new = alpha * v_new
            p_new = jnp.concatenate([x_new, v_new, f_new], axis=1)
            return (p_new, w + dk), (e + kin + dk, kin + dk, w + dk)
        return body

    def outer(carry, _):
        p, w, k = carry
        k, sub = jax.random.split(k)
        nb = init_nb(p[:, 0:3])
        (p, w), ys = jax.lax.scan(
            inner(nb), (p, w), jax.random.split(sub, rebuild_every))
        return (p, w, k), ys

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, _w, _k), (etot, kes, ws) = jax.lax.scan(
        outer, (p0, jnp.zeros((), dtype), key), None,
        length=n_steps // rebuild_every)
    nb = init_nb(p[:, 0:3])
    e_pot, _f, nb = e_fn(p[:, 0:3], nb)
    final = MDStateNB(p[:, 0:3], p[:, 3:6], p[:, 6:9], e_pot, nb)
    return final, {"etot": etot.reshape(-1), "kinetic": kes.reshape(-1),
                   "work": ws.reshape(-1)}


def csvr_trajectory(state, energy_fn, masses, dt: float, temperature: float,
                    tau: float, key, n_steps: int, n_constraints: int = 0):
    """Dense-route CSVR driver (no neighbor reuse): velocity-Verlet + one
    global rescale per step.  Returns ``(final_state, diag)`` with the
    same ``{"etot", "kinetic", "work"}`` series as
    :func:`csvr_trajectory_nb` (``etot - work`` conserved).

    Exactly resumable with ``advance_key(key, n_steps)`` — the key is
    chained one split per step, the same convention as the dense
    ``integrate.langevin_trajectory``."""
    from .integrate import MDState

    masses = jnp.asarray(masses)
    dtype = state.positions.dtype
    n_dof = 3 * state.positions.shape[0] - n_constraints
    inv_m = (0.5 * dt / masses)[:, None]
    grad_e = jax.value_and_grad(energy_fn)

    def body(carry, _):
        x, v, f, w, k = carry
        k, kk = jax.random.split(k)
        v_half = v + f * inv_m
        x_new = x + dt * v_half
        e, g = grad_e(x_new)
        f_new = -g
        v_new = v_half + f_new * inv_m
        kin = kinetic_energy(v_new, masses)
        alpha, dk = csvr_scale(kin, n_dof, dt, tau, temperature, kk, dtype)
        v_new = alpha * v_new
        return ((x_new, v_new, f_new, w + dk, k),
                (e + kin + dk, kin + dk, w + dk))

    (x, v, f, _w, _k), (etot, kes, ws) = jax.lax.scan(
        body, (state.positions, state.velocities, state.forces,
               jnp.zeros((), dtype), key), None, length=n_steps)
    e_pot = energy_fn(x)
    return MDState(x, v, f, e_pot), {"etot": etot, "kinetic": kes,
                                     "work": ws}
