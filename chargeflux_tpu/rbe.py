"""Random batch Ewald (RBE) — stochastic O(N p) reciprocal space.

Opt-in alternative reciprocal estimator after Jin, Li, Xu & Zhao, "A
random batch Ewald method for particle systems with Coulomb
interactions" (SIAM J. Sci. Comput. 43, B937 (2021); PAPERS.md): instead
of summing every k-vector (classical, ewald.py) or spreading onto an FFT
mesh (PME, pme.py), draw ``p`` k-vectors from the Ewald Gaussian
``P(k) ∝ exp(-k^2/4a^2)`` each step and use the importance-sampled
estimator

    E_rec ≈ (2 pi k_e / V) * Z * (1/p) sum_l 1{k_l != 0} |S(k_l)|^2 / k_l^2

with ``Z = prod_a sum_n exp(-(2 pi n / L_a)^2 / 4 a^2)`` the exact
partition constant (per-axis sums — the product distribution factorizes
for an orthorhombic box, which this route requires).  The estimator is
UNBIASED in the energy, the forces and dE/dq (the sample distribution is
position-independent, so the gradient of an unbiased estimator is an
unbiased gradient); the O(p) variance is absorbed by a thermostat
exactly like the random force of Langevin dynamics — use it for NVT/NPT
sampling, never for microcanonical NVE or energy minimization.

Shape: per step, sampling is three categorical draws from static
log-prob tables and the evaluation is one [N, p] phase build + two
cos/sin contractions — no FFT, no k-grid, cost O(N p) with p ~ 100-500
independent of box size.  That undercuts even the PME mesh cost for
large boxes, at the price of stochastic forces.

Like the reference's reciprocal loops (ReferenceCoulKernels.cpp:519-556)
this computes the same Ewald splitting as the rest of the engine — self,
direct and exclusion terms are unchanged; only the k-space sum is
estimated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .units import ONE_4PI_EPS0


class RBETables(NamedTuple):
    """Static sampling tables for one (box, alpha) pair (trace-time)."""

    logp: tuple          # 3 numpy [2M_a+1] log-prob tables (unnormalized)
    nvals: tuple         # 3 numpy [2M_a+1] integer n values
    z_const: float       # prod_a sum_n f_a(n)  (includes the n=0 triple)
    box: tuple           # creation-time box lengths the tables assume
    alpha: float


def rbe_tables(box, alpha: float, tail: float = 1e-12) -> RBETables:
    """Per-axis discrete-Gaussian tables with relative tail mass < tail.

    ``f_a(n) = exp(-(2 pi n / L_a)^2 / 4 alpha^2)``; M_a grows until the
    dropped tail is below ``tail`` relative to the axis sum.
    """
    box = np.asarray(box, np.float64).reshape(-1)
    if box.size != 3:
        raise ValueError("RBE requires an orthorhombic [3] box (the "
                         "product sampling distribution factorizes "
                         "per axis)")
    logp, nvals = [], []
    z = 1.0
    for length in box:
        c = (2.0 * math.pi / float(length)) ** 2 / (4.0 * alpha * alpha)
        m = 1
        while math.exp(-c * (m + 1) ** 2) > tail:
            m += 1
        n = np.arange(-m, m + 1)
        f = np.exp(-c * n.astype(np.float64) ** 2)
        z *= float(f.sum())
        logp.append(-c * n.astype(np.float64) ** 2)
        nvals.append(n)
    return RBETables(logp=tuple(logp), nvals=tuple(nvals), z_const=z,
                     box=tuple(float(b) for b in box), alpha=float(alpha))


def sample_kvecs(tables: RBETables, n_samples: int, key, dtype):
    """Draw ``n_samples`` k-vectors from the factorized Ewald Gaussian.

    Returns (k [p, 3] Cartesian, k2 [p], nonzero [p] bool).  The zero
    triple is kept in the draw (its contribution is masked in the
    estimator; keeping it preserves the exact product distribution the
    ``Z`` constant normalizes).
    """
    keys = jax.random.split(key, 3)
    cols = []
    for a in range(3):
        lp = jnp.asarray(tables.logp[a])
        idx = jax.random.categorical(keys[a], lp, shape=(n_samples,))
        cols.append(jnp.asarray(tables.nvals[a])[idx])
    n = jnp.stack(cols, axis=1)                       # [p, 3] integers
    two_pi = 2.0 * math.pi
    scale = jnp.asarray([two_pi / b for b in tables.box], dtype)
    k = n.astype(dtype) * scale[None, :]
    k2 = jnp.sum(k * k, axis=1)
    nonzero = jnp.any(n != 0, axis=1)
    return k, k2, nonzero


def rbe_reciprocal_energy(positions, q, tables: RBETables, n_samples: int,
                          key) -> jax.Array:
    """Unbiased one-sample estimate of the reciprocal-space energy.

    ``E ≈ (2 pi k_e / V) Z (1/p) sum_l |S(k_l)|^2 / k_l^2`` over nonzero
    draws.  Differentiable in positions and q (stochastic but unbiased
    forces/dedq); the draw is fixed by ``key``.
    """
    dtype = positions.dtype
    k, k2, nonzero = sample_kvecs(tables, n_samples, key, dtype)
    k = jax.lax.stop_gradient(k)
    k2 = jax.lax.stop_gradient(k2)
    # [N, p] phases; elementwise broadcast (an unpinned [N,3]x[3,p] f32 dot
    # may run at reduced precision — repo precision rule)
    phase = (positions[:, 0:1] * k[None, :, 0]
             + positions[:, 1:2] * k[None, :, 1]
             + positions[:, 2:3] * k[None, :, 2])
    s_cos = jnp.sum(q[:, None] * jnp.cos(phase), axis=0)    # [p]
    s_sin = jnp.sum(q[:, None] * jnp.sin(phase), axis=0)
    k2_safe = jnp.where(nonzero, k2, 1.0)
    contrib = jnp.where(nonzero, (s_cos * s_cos + s_sin * s_sin) / k2_safe,
                        0.0)
    vol = tables.box[0] * tables.box[1] * tables.box[2]
    c = 2.0 * math.pi * ONE_4PI_EPS0 / vol
    return jnp.asarray(c * tables.z_const / n_samples, dtype) * jnp.sum(
        contrib)


def make_rbe_nb_energy_fn(system, n_samples: int, bonded=None,
                          guard: bool = True):
    """Stochastic-reciprocal energy for NVT trajectory loops.

    Returns ``(e_fn, init_nb)`` with ``e_fn(x, nb, key) ->
    (energy, forces, nb)`` — the RBE analog of
    :func:`integrate.make_nb_energy_fn`, with the classical/PME
    reciprocal term replaced by the random-batch estimator (everything
    else — self, direct walk, exclusions, flux charges, the overflow
    NaN-poison and the freshness guard — identical).  Requires a
    periodic orthorhombic system.

    Choosing ``n_samples`` (p) — measured noise at the 100k bench config,
    thermalized liquid: single-draw force noise / total-force RMS = 1.21 /
    0.84 / 0.61 / 0.44 at p = 32 / 64 / 128 / 256 (exact 1/sqrt(p)
    scaling).  The noise is zero-mean per step, so
    the operative budget is the induced velocity kick 0.5*dt*dF/m
    against the thermostat's own stochastic kick
    ~sqrt(2*friction*dt)*v_thermal: keep the ratio under ~1/4.  At
    dt = 0.5 fs, friction = 20/ps that is p >= ~128; the required p
    scales ~1/friction and ~dt.  Weakly coupled thermostats (friction
    ~1/ps) need p in the several-hundreds — at which point PME may win
    again; measure at your config.  Never use RBE for NVE or
    minimization (the estimator variance is absorbed only by a
    thermostat), and average energies over steps (unbiased, but one draw
    carries ~0.007 kJ/mol/atom std at p=128).
    """
    from .charges import effective_charges
    from .energy import energy_components_fixed_charges
    from .neighbors import build_neighbor_state, neighbor_state_fresh

    spec = system.spec
    if not spec.pbc:
        raise ValueError("RBE is an Ewald reciprocal estimator; the "
                         "system must be periodic")
    tables = rbe_tables(np.asarray(jax.device_get(system.box)), spec.alpha)
    has_cells = spec.direct_method == "cell"

    def init_nb(x):
        if not has_cells:
            return None
        return jax.lax.stop_gradient(build_neighbor_state(x, system))

    def e_fn(x, nb, key):
        def e_of(xx):
            q = effective_charges(xx, system)
            comps = energy_components_fixed_charges(xx, q, system, nb=nb,
                                                    include_recip=False)
            e = (sum(comps.values())
                 + rbe_reciprocal_energy(xx, q, tables, n_samples, key))
            if bonded is not None:
                from .bonded import bonded_energy
                e = e + bonded_energy(xx, bonded)
            return e

        e, g = jax.value_and_grad(e_of)(x)
        if guard and nb is not None:
            bad = jnp.where(neighbor_state_fresh(nb, x, system), 1.0,
                            jnp.asarray(jnp.nan, e.dtype))
            e = e * bad
            g = g * bad
        return e, -g, nb

    return e_fn, init_nb


def rbe_langevin_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                               temperature: float, friction: float, key,
                               n_steps: int, rebuild_every: int = 10):
    """BAOAB Langevin with a fresh RBE draw per step (the thermostat
    absorbs the estimator variance — Jin et al. §4).  Same packed
    ``[N, 9]`` carry / chunked-rebuild / advance_key conventions as
    :func:`integrate.langevin_trajectory_nb`; each step key is split
    into (BAOAB noise, RBE draw)."""
    from .integrate import (MDStateNB, baoab_coeffs, baoab_pre_force,
                            kinetic_energy)

    if n_steps % rebuild_every or n_steps == 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature, state.positions.dtype)

    def inner(nb):
        def body(p, kk):
            k_o, k_rbe = jax.random.split(kk)
            x, v = baoab_pre_force(p[:, 0:3], p[:, 3:6], p[:, 6:9],
                                   inv_m, dt, c1, c2, k_o)
            _e, f, _nb = e_fn(x, nb, k_rbe)
            v = v + 0.5 * dt * f * inv_m
            return (jnp.concatenate([x, v, f], axis=1),
                    kinetic_energy(v, masses))
        return body

    def outer(carry, _):
        p, k = carry
        k, sub = jax.random.split(k)
        nb = init_nb(p[:, 0:3])
        p, kes = jax.lax.scan(inner(nb), p,
                              jax.random.split(sub, rebuild_every))
        return (p, k), kes

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, _k), kes = jax.lax.scan(outer, (p0, key), None,
                                length=n_steps // rebuild_every)
    nb = init_nb(p[:, 0:3])
    k_final = jax.random.split(_k)[1]
    e_pot, _f, nb = e_fn(p[:, 0:3], nb, k_final)
    final = MDStateNB(p[:, 0:3], p[:, 3:6], p[:, 6:9], e_pot, nb)
    return final, kes.reshape(-1)
