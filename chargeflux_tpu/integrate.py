"""Velocity-Verlet NVE integration as a jit/scan loop.

The reference plugin delegates integration to OpenMM's Context/Integrator
machinery (SURVEY §1 L0).  Here an MD step is a pure function over a
(positions, velocities, forces) state pytree driven by an arbitrary
``energy_fn(positions) -> scalar`` (e.g. charge-flux electrostatics + bonded
terms); a trajectory is lax.scan over it — the entire loop compiles to a
single XLA program with no host round-trips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .bonded import bonded_energy
from .energy import _energy


class MDState(NamedTuple):
    positions: jax.Array   # [N, 3] nm
    velocities: jax.Array  # [N, 3] nm/ps
    forces: jax.Array      # [N, 3] kJ/mol/nm
    potential: jax.Array   # scalar kJ/mol


def make_energy_fn(system, bonded=None) -> Callable:
    """Charge-flux electrostatics (+ optional bonded terms) as a closure
    suitable for the integrator."""

    def e_fn(x):
        e = _energy(x, system)
        if bonded is not None:
            e = e + bonded_energy(x, bonded)
        return e

    return e_fn


def init_state(positions, velocities, energy_fn) -> MDState:
    e, g = jax.value_and_grad(energy_fn)(positions)
    return MDState(positions, velocities, -g, e)


# ---------------------------------------------------------------------------
# Neighbor-state-threaded trajectories (amortized cell-list rebuilds)
# ---------------------------------------------------------------------------


class MDStateNB(NamedTuple):
    positions: jax.Array
    velocities: jax.Array
    forces: jax.Array
    potential: jax.Array
    nb: object             # neighbors.NeighborState


def make_nb_energy_fn(system, bonded=None, guard: bool = True):
    """Stateful energy for trajectory loops: returns (e_fn, init_nb) where
    ``e_fn(x, nb) -> (energy, forces, nb)`` evaluates with a reused neighbor
    state and ``init_nb(x)`` (re)builds one.

    Rebuild *scheduling* lives in the trajectory drivers, which rebuild
    unconditionally every ``rebuild_every`` steps in a nested scan — a
    data-dependent ``lax.cond`` rebuild keeps a conditional in every step
    (whether a displacement trigger pays on the card awaits an A/B).  With ``guard`` (default), a step whose
    displacement invalidates the reused state poisons the energy to NaN —
    an over-optimistic rebuild interval is visible, never silently wrong.
    """
    from .neighbors import build_neighbor_state, neighbor_state_fresh

    has_cells = system.spec.direct_method == "cell"

    def init_nb(x):
        if not has_cells:
            return None        # dense route: nothing to reuse
        return jax.lax.stop_gradient(build_neighbor_state(x, system))

    def e_fn(x, nb):
        def e_of(xx):
            e = _energy(xx, system, nb=nb)
            if bonded is not None:
                e = e + bonded_energy(xx, bonded)
            return e

        e, g = jax.value_and_grad(e_of)(x)
        if guard and nb is not None:
            # poison energy AND forces (a stale neighbor state makes the
            # forces quietly wrong; force-only consumers must see it too)
            bad = jnp.where(neighbor_state_fresh(nb, x, system), 1.0,
                            jnp.asarray(jnp.nan, e.dtype))
            e = e * bad
            g = g * bad
        return e, -g, nb

    return e_fn, init_nb


def init_state_nb(positions, velocities, e_fn, init_nb) -> MDStateNB:
    nb = init_nb(positions)
    e, f, nb = e_fn(positions, nb)
    return MDStateNB(positions, velocities, f, e, nb)


def nve_step_nb(state: MDStateNB, e_fn, masses, dt: float) -> MDStateNB:
    """Velocity-Verlet step with a reused neighbor state."""
    inv_m = (1.0 / masses)[:, None]
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    x_new = state.positions + dt * v_half
    e, f_new, nb = e_fn(x_new, state.nb)
    v_new = v_half + 0.5 * dt * f_new * inv_m
    return MDStateNB(x_new, v_new, f_new, e, nb)


# Packed-carry representation knob:
# "packed"   — [N, 9] x|v|f
# "barrier"  — [N, 9] with lax.optimization_barrier on the carry at each
#              inner-step boundary (pins the layout choice against the
#              energy graph's preferences)
# "flat"     — [N*9] 1-D carry, reshaped to [N, 9] inside the step (a 1-D
#              buffer has exactly one layout, so the loop boundary cannot
#              relayout it; the replica drivers already carry flat)
# "xbarrier" — barrier on the positions handed TO the energy fn (stops
#              the energy graph's gather-driven layout preference from
#              propagating back into the carry buffer)
# "fbarrier" — barrier on the forces coming OUT of the energy fn
# "xfbarrier"— both
# Module-level so measurement tools can A/B without threading an arg
# through every driver.  Default "xbarrier": the hetero energy graph's
# gather-driven layout preference can propagate back into the packed
# carry buffer and relayout it at every loop boundary; a barrier on the
# positions handed to the energy fn severs exactly that edge.  Whether it
# pays on the card awaits an A/B.
PACKED_CARRY_MODE = "xbarrier"
_MODES = ("packed", "barrier", "flat", "xbarrier", "fbarrier", "xfbarrier")


def x_into_energy(x, mode: str | None = None):
    """Positions at the carry -> energy-graph boundary: under the
    "xbarrier"/"xfbarrier" carry modes (the production default, see
    :data:`PACKED_CARRY_MODE`), wrap them in
    ``lax.optimization_barrier`` so the energy graph's layout preference
    cannot propagate into the scan carry buffer.  Identity otherwise.
    Every packed-carry trajectory driver routes the positions it hands
    its energy/force closure through this helper; the unbarriered
    positions still feed the integrator arithmetic and the carry."""
    m = PACKED_CARRY_MODE if mode is None else mode
    if m in ("xbarrier", "xfbarrier"):
        return jax.lax.optimization_barrier(x)
    return x


def make_packed_nve_chunk(e_fn, init_nb, masses, dt: float,
                          rebuild_every: int, carry: str | None = None):
    """Packed-carry NVE building block: returns (pack, unpack, outer) where
    ``outer(p, _)`` rebuilds the neighbor state and advances
    ``rebuild_every`` velocity-Verlet steps on a single ``[N, 9]`` carry
    array holding x|v|f side by side.

    Why packed: with positions/velocities/forces as three separate
    ``[N, 3]`` scan carries XLA may give each narrow carry its own padded
    layout and relayout it at the loop boundary every iteration; one
    packed array makes that a single buffer.  The per-step scan output is total energy (potential +
    kinetic).  The neighbor state is closed over by the inner scan, not
    carried (it is constant between rebuilds).  ``carry`` selects the
    carry representation (default :data:`PACKED_CARRY_MODE`)."""
    mode = PACKED_CARRY_MODE if carry is None else carry
    if mode not in _MODES:
        raise ValueError(f"unknown packed-carry mode {mode!r}")
    inv_m_v = 0.5 * dt / jnp.asarray(masses)

    def pack(state: MDStateNB):
        p = jnp.concatenate(
            [state.positions, state.velocities, state.forces], axis=1)
        return p.reshape(-1) if mode == "flat" else p

    def unpack(p, potential, nb):
        p = p.reshape(-1, 9) if mode == "flat" else p
        return MDStateNB(p[:, 0:3], p[:, 3:6], p[:, 6:9], potential, nb)

    def make_inner(nb):
        def inner(p, _):
            p2 = p.reshape(-1, 9) if mode == "flat" else p
            x, v, f = p2[:, 0:3], p2[:, 3:6], p2[:, 6:9]
            inv_m = inv_m_v[:, None]
            v_half = v + f * inv_m
            x_new = x + dt * v_half
            e, f_new, _ = e_fn(x_into_energy(x_new, mode), nb)
            if mode in ("fbarrier", "xfbarrier"):
                f_new = jax.lax.optimization_barrier(f_new)
            v_new = v_half + f_new * inv_m
            p_new = jnp.concatenate([x_new, v_new, f_new], axis=1)
            if mode == "flat":
                p_new = p_new.reshape(-1)
            elif mode == "barrier":
                p_new = jax.lax.optimization_barrier(p_new)
            return p_new, e + kinetic_energy(v_new, masses)
        return inner

    def outer(p, _):
        x0 = (p.reshape(-1, 9)[:, 0:3] if mode == "flat" else p[:, 0:3])
        nb = init_nb(x0)
        return jax.lax.scan(make_inner(nb), p, None, length=rebuild_every)

    return pack, unpack, outer


def nve_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses, dt: float,
                      n_steps: int, rebuild_every: int = 10):
    """n_steps of NVE with the cell list rebuilt every ``rebuild_every``
    steps (unconditionally, in a nested scan — see make_nb_energy_fn);
    returns (final_state, per-step total energies).

    Pick ``rebuild_every`` so the fastest atoms move < skin/2 between
    rebuilds (neighbors.skin_radius); the guard in e_fn NaN-poisons the
    energy if the interval was too long.  The scans run on a packed
    ``[N, 9]`` carry (see :func:`make_packed_nve_chunk`)."""
    if n_steps == 0:
        return state, jnp.zeros((0,), state.positions.dtype)

    n_outer, rem = divmod(n_steps, rebuild_every)
    pack, unpack, outer = make_packed_nve_chunk(
        e_fn, init_nb, masses, dt, rebuild_every)
    p = pack(state)
    es = []
    if n_outer:
        p, e_chunks = jax.lax.scan(outer, p, None, length=n_outer)
        es.append(e_chunks.reshape(-1))
    if rem:
        _, _, outer_rem = make_packed_nve_chunk(
            e_fn, init_nb, masses, dt, rem)
        p, e_tail = jax.lax.scan(outer_rem, p, None, length=1)
        es.append(e_tail.reshape(-1))
    # final consistent state: fresh neighbor state + potential at x_final
    x_fin = p.reshape(-1, 9)[:, 0:3]
    nb = init_nb(x_fin)
    e_pot, _f, nb = e_fn(x_fin, nb)
    state = unpack(p, e_pot, nb)
    return state, jnp.concatenate(es) if len(es) != 1 else es[0]


def advance_key(key, n_chunks: int):
    """The carry key a chunk-chained stochastic driver holds after
    consuming ``n_chunks`` links of its split chain.  Applies to the
    drivers that do one ``k, sub = split(k)`` per chunk:
    ``langevin_trajectory_nb`` / ``rattle_langevin_trajectory_nb`` /
    ``respa_langevin_trajectory_nb`` / ``csvr.csvr_trajectory_nb`` /
    ``npt_langevin_trajectory`` (one link per outer rebuild interval)
    and the dense ``langevin_trajectory`` /
    ``csvr.csvr_trajectory`` (one link per step).  It does NOT reproduce
    ``constraints.rattle_langevin_trajectory``'s stream — that dense
    driver does a flat ``split(key, n_steps)`` upfront; resume it with a
    fresh key or use the ``_nb`` variant.

    Enables exact checkpoint/resume: running ``n_steps`` in one call is
    bitwise identical to running the first half, checkpointing the final
    state, and resuming with ``advance_key(key, chunks_consumed)`` —
    see tests/test_integrate.py::test_langevin_nb_resume_exact."""
    def link(k, _):
        return jax.random.split(k)[0], None

    return jax.lax.scan(link, key, None, length=n_chunks)[0]


def langevin_trajectory_nb(state: MDStateNB, e_fn, init_nb, masses,
                           dt: float, temperature: float, friction: float,
                           key, n_steps: int, rebuild_every: int = 10):
    """n_steps of BAOAB Langevin with the neighbor state rebuilt every
    ``rebuild_every`` steps — the NVT analog of :func:`nve_trajectory_nb`
    (same packed ``[N, 9]`` carry, same unconditional nested-scan rebuild
    and freshness guard via ``e_fn``).  Returns (final_state, per-step
    kinetic energies).

    Exactly resumable: a second call from the returned state with
    ``advance_key(key, n_steps // rebuild_every)`` continues the
    trajectory bitwise (the final state keeps the *carry* forces the next
    chunk's first B kick would consume, not a fresh recomputation whose
    summation order differs)."""
    if n_steps % rebuild_every or n_steps == 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature,
                          state.positions.dtype)

    def inner(nb):
        def body(p, kk):
            x, v = baoab_pre_force(p[:, 0:3], p[:, 3:6], p[:, 6:9],
                                   inv_m, dt, c1, c2, kk)
            _e, f, _nb = e_fn(x_into_energy(x), nb)
            v = v + 0.5 * dt * f * inv_m                            # B
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
    e_pot, _f, nb = e_fn(p[:, 0:3], nb)
    final = MDStateNB(p[:, 0:3], p[:, 3:6], p[:, 6:9], e_pot, nb)
    return final, kes.reshape(-1)


# ---------------------------------------------------------------------------
# Multi-timestep r-RESPA (impulse / Verlet-I) — bonded inner steps
# ---------------------------------------------------------------------------


def make_respa_force_fns(system, bonded, guard: bool = True):
    """Split the force field into RESPA tiers: (slow_fn, fast_fn, init_nb).

    ``slow_fn(x, nb) -> (energy, forces, nb)`` is the charge-flux nonbonded
    tier (self/reciprocal/direct/exclusions + LJ) with neighbor-state reuse
    and the freshness guard of :func:`make_nb_energy_fn` — expensive and
    slowly varying, evaluated once per outer step.  ``fast_fn(x) ->
    (energy, forces)`` is the harmonic bonded tier — cheap and rapidly
    varying (OH stretches), evaluated every inner substep."""
    slow_fn, init_nb = make_nb_energy_fn(system, bonded=None, guard=guard)

    def fast_fn(x):
        e, g = jax.value_and_grad(bonded_energy)(x, bonded)
        return e, -g

    return slow_fn, fast_fn, init_nb


def _pack12(x, v, f_slow, f_fast):
    return jnp.concatenate([x, v, f_slow, f_fast], axis=1)


def respa_trajectory_nb(state: MDStateNB, slow_fn, fast_fn, init_nb, masses,
                        dt: float, n_inner: int, n_steps: int,
                        rebuild_every: int = 10):
    """Impulse r-RESPA NVE trajectory (Verlet-I; Tuckerman-Berne-Martyna
    splitting): each outer step of ``dt`` applies half-step velocity kicks
    from the slow (nonbonded) force at the boundaries and advances
    ``n_inner`` velocity-Verlet substeps of ``dt / n_inner`` on the fast
    (bonded) force.  With flexible charge-flux water the whole-step
    stability limit (~0.5 fs, OH stretch) moves to the inner tier, so the
    expensive nonbonded evaluation runs once per 1.5-2.5 fs outer step —
    a ~n_inner-fold ns/day lever where the nonbonded step dominates.

    The reference plugin delegates integration to its host framework
    (SURVEY §1 L0); this is the L0 replacement's multi-timestep integrator
    (OpenMM ``MTSIntegrator`` analog).  ``n_steps`` counts *outer* steps
    and must be a positive multiple of ``rebuild_every`` (the neighbor
    state rebuilds every ``rebuild_every`` outer steps, unconditionally,
    in a nested scan — see :func:`make_nb_energy_fn`).  Scans run on one
    packed ``[N, 12]`` x|v|f_slow|f_fast carry (see
    :func:`make_packed_nve_chunk` for why packed).  Returns
    (final_state, per-outer-step total energies)."""
    if n_steps % rebuild_every or n_steps <= 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    dt_in = dt / n_inner

    def inner(q, _):
        x, v, f = q[:, 0:3], q[:, 3:6], q[:, 6:9]
        v_half = v + 0.5 * dt_in * f * inv_m
        x_new = x + dt_in * v_half
        e_fast, f_new = fast_fn(x_new)
        v_new = v_half + 0.5 * dt_in * f_new * inv_m
        return jnp.concatenate([x_new, v_new, f_new], axis=1), e_fast

    def make_outer_step(nb):
        def body(p, _):
            x, v = p[:, 0:3], p[:, 3:6]
            f_slow, f_fast = p[:, 6:9], p[:, 9:12]
            v = v + 0.5 * dt * f_slow * inv_m              # slow kick
            q = jnp.concatenate([x, v, f_fast], axis=1)
            q, e_fasts = jax.lax.scan(inner, q, None, length=n_inner)
            x, v, f_fast = q[:, 0:3], q[:, 3:6], q[:, 6:9]
            e_slow, f_slow, _nb = slow_fn(x_into_energy(x), nb)
            v = v + 0.5 * dt * f_slow * inv_m              # slow kick
            e_tot = e_slow + e_fasts[-1] + kinetic_energy(v, masses)
            return _pack12(x, v, f_slow, f_fast), e_tot
        return body

    def outer(p, _):
        nb = init_nb(p[:, 0:3])
        return jax.lax.scan(make_outer_step(nb), p, None,
                            length=rebuild_every)

    nb = init_nb(state.positions)
    _e, f_slow0, _nb = slow_fn(state.positions, nb)
    _ef, f_fast0 = fast_fn(state.positions)
    p = _pack12(state.positions, state.velocities, f_slow0, f_fast0)
    p, etots = jax.lax.scan(outer, p, None, length=n_steps // rebuild_every)
    x = p[:, 0:3]
    nb = init_nb(x)
    e_slow, f_slow, nb = slow_fn(x, nb)
    e_fast, f_fast = fast_fn(x)
    final = MDStateNB(x, p[:, 3:6], f_slow + f_fast, e_slow + e_fast, nb)
    return final, etots.reshape(-1)


def make_packed_respa_langevin_chunk(slow_fn, fast_fn, init_nb, masses,
                                     dt: float, n_inner: int,
                                     temperature: float, friction: float,
                                     rebuild_every: int, dtype):
    """Packed-carry NVT r-RESPA building block: returns (init_carry,
    outer) where ``outer((p, key), _)`` rebuilds the neighbor state and
    advances ``rebuild_every`` outer RESPA steps on a ``[N, 12]``
    x|v|f_slow|f_fast carry, emitting per-outer-step kinetic energies.
    Shared by :func:`respa_langevin_trajectory_nb` and the benchmark
    harness (one implementation of the step)."""
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    dt_in = dt / n_inner
    c1, c2 = baoab_coeffs(dt_in, friction, temperature, dtype)

    def inner(q, kk):
        x, v, f = q[:, 0:3], q[:, 3:6], q[:, 6:9]
        x, v = baoab_pre_force(x, v, f, inv_m, dt_in, c1, c2, kk)
        _e, f_new = fast_fn(x)
        v = v + 0.5 * dt_in * f_new * inv_m                # B (fast)
        return jnp.concatenate([x, v, f_new], axis=1), None

    def make_outer_step(nb):
        def body(p, kk):
            x, v = p[:, 0:3], p[:, 3:6]
            f_slow, f_fast = p[:, 6:9], p[:, 9:12]
            v = v + 0.5 * dt * f_slow * inv_m              # slow kick
            q = jnp.concatenate([x, v, f_fast], axis=1)
            ks = kk[None] if n_inner == 1 else jax.random.split(kk, n_inner)
            q, _ = jax.lax.scan(inner, q, ks)
            x, v, f_fast = q[:, 0:3], q[:, 3:6], q[:, 6:9]
            _e, f_slow, _nb = slow_fn(x_into_energy(x), nb)
            v = v + 0.5 * dt * f_slow * inv_m              # slow kick
            return (_pack12(x, v, f_slow, f_fast),
                    kinetic_energy(v, masses))
        return body

    def outer(carry, _):
        p, k = carry
        k, sub = jax.random.split(k)
        nb = init_nb(p[:, 0:3])
        p, kes = jax.lax.scan(make_outer_step(nb), p,
                              jax.random.split(sub, rebuild_every))
        return (p, k), kes

    def init_carry(state: MDStateNB, key):
        nb = init_nb(state.positions)
        _e, f_slow0, _nb = slow_fn(state.positions, nb)
        _ef, f_fast0 = fast_fn(state.positions)
        return (_pack12(state.positions, state.velocities, f_slow0,
                        f_fast0), key)

    return init_carry, outer


def respa_langevin_trajectory_nb(state: MDStateNB, slow_fn, fast_fn,
                                 init_nb, masses, dt: float, n_inner: int,
                                 temperature: float, friction: float, key,
                                 n_steps: int, rebuild_every: int = 10):
    """BAOAB Langevin with impulse slow forces — the NVT analog of
    :func:`respa_trajectory_nb`: the inner tier runs ``n_inner`` BAOAB
    substeps of ``dt / n_inner`` on the fast (bonded) force (friction and
    noise act at the inner timestep, where the fast dynamics live), the
    slow (nonbonded) force kicks at the outer boundaries.  With
    ``n_inner=1`` this reproduces :func:`langevin_trajectory_nb` exactly
    (same key schedule, kicks differ only by summation order).  Returns
    (final_state, per-outer-step kinetic energies)."""
    if n_steps % rebuild_every or n_steps <= 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    init_carry, outer = make_packed_respa_langevin_chunk(
        slow_fn, fast_fn, init_nb, masses, dt, n_inner, temperature,
        friction, rebuild_every, state.positions.dtype)
    (p, _k), kes = jax.lax.scan(outer, init_carry(state, key), None,
                                length=n_steps // rebuild_every)
    x = p[:, 0:3]
    nb = init_nb(x)
    e_slow, f_slow, nb = slow_fn(x, nb)
    e_fast, f_fast = fast_fn(x)
    final = MDStateNB(x, p[:, 3:6], f_slow + f_fast, e_slow + e_fast, nb)
    return final, kes.reshape(-1)


def nve_step(state: MDState, energy_fn, masses: jax.Array, dt: float) -> MDState:
    """One velocity-Verlet step.  masses [N] in amu; dt in ps."""
    inv_m = (1.0 / masses)[:, None]
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    x_new = state.positions + dt * v_half
    e, g = jax.value_and_grad(energy_fn)(x_new)
    f_new = -g
    v_new = v_half + 0.5 * dt * f_new * inv_m
    return MDState(x_new, v_new, f_new, e)


def kinetic_energy(velocities, masses) -> jax.Array:
    return 0.5 * jnp.sum(masses[:, None] * velocities * velocities)


def temperature(velocities, masses, n_constraints: int = 0) -> jax.Array:
    """Instantaneous kinetic temperature in K: 2K / ((3N - n_c) kB).

    ``n_constraints`` subtracts constrained degrees of freedom (3 per
    rigid water from constraints.RigidWaterParams.n_constraints; OpenMM
    does the same accounting).  Flexible systems use the default 3N."""
    from .units import BOLTZ
    n_dof = 3.0 * velocities.shape[0] - n_constraints
    return 2.0 * kinetic_energy(velocities, masses) / (n_dof * BOLTZ)


def maxwell_velocities(masses, temp: float, key,
                       dtype=None, zero_momentum: bool = True) -> jax.Array:
    """Maxwell-Boltzmann velocities at ``temp`` K (nm/ps), with the
    center-of-mass drift removed by default (OpenMM's
    ``setVelocitiesToTemperature`` equivalent — the L0 service the
    reference inherits from its host framework).

    COM removal takes 3 of the 3N degrees of freedom, which would read
    (1 - 1/N) low on :func:`temperature`'s 3N-DoF definition — noticeable
    for small N — so the drift-free velocities are rescaled by
    sqrt(3N / (3N - 3)) to restore the expected kinetic energy."""
    from .units import BOLTZ
    m = jnp.asarray(masses, dtype or jnp.result_type(float))
    n = m.shape[0]
    sigma = jnp.sqrt(BOLTZ * temp / m)[:, None]
    v = sigma * jax.random.normal(key, (n, 3), dtype=sigma.dtype)
    if zero_momentum and n > 1:
        v = v - jnp.sum(m[:, None] * v, axis=0) / jnp.sum(m)
        v = v * jnp.sqrt(3.0 * n / (3.0 * n - 3.0))
    return v


def nve_trajectory(state: MDState, energy_fn, masses, dt: float, n_steps: int):
    """Run n_steps of NVE; returns (final_state, per-step total energies).

    Scans on a packed ``[N, 9]`` x|v|f carry plus the potential (see
    :func:`make_packed_nve_chunk` for why)."""

    def body(carry, _):
        p, pot = carry
        s = MDState(p[:, 0:3], p[:, 3:6], p[:, 6:9], pot)
        s = nve_step(s, energy_fn, masses, dt)
        e_tot = s.potential + kinetic_energy(s.velocities, masses)
        p = jnp.concatenate([s.positions, s.velocities, s.forces], axis=1)
        return (p, s.potential), e_tot

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, pot), es = jax.lax.scan(body, (p0, state.potential), None,
                                length=n_steps)
    return MDState(p[:, 0:3], p[:, 3:6], p[:, 6:9], pot), es


# ---------------------------------------------------------------------------
# Langevin (NVT) — BAOAB splitting
# ---------------------------------------------------------------------------


def baoab_coeffs(dt: float, friction: float, temperature: float, dtype):
    """(c1, c2) of the O-step: v <- c1 v + c2 sqrt(1/m) noise."""
    from .units import BOLTZ
    kt = BOLTZ * temperature
    c1 = jnp.exp(jnp.asarray(-friction * dt, dtype))
    return c1, jnp.sqrt((1.0 - c1 * c1) * kt)


def baoab_pre_force(x, v, f, inv_m, dt, c1, c2, key):
    """The B-A-O-A half of one BAOAB step (Leimkuhler-Matthews); the
    caller evaluates forces at the returned x and applies the final B
    half-kick.  The ONE implementation shared by langevin_step,
    langevin_trajectory_nb and npt_langevin_trajectory — an O-step change
    here reaches every NVT/NPT driver."""
    v = v + 0.5 * dt * f * inv_m                                    # B
    x = x + 0.5 * dt * v                                            # A
    noise = jax.random.normal(key, v.shape, dtype=v.dtype)
    v = c1 * v + c2 * jnp.sqrt(inv_m) * noise                       # O
    x = x + 0.5 * dt * v                                            # A
    return x, v


def langevin_step(state: MDState, energy_fn, masses, dt: float,
                  temperature: float, friction: float, key) -> MDState:
    """One BAOAB Langevin step (Leimkuhler-Matthews splitting).

    friction in 1/ps, temperature in K.  The O-step noise uses the provided
    PRNG key; thread keys with jax.random.split in the caller/scan.
    """
    inv_m = (1.0 / masses)[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature,
                          state.positions.dtype)
    x, v = baoab_pre_force(state.positions, state.velocities, state.forces,
                           inv_m, dt, c1, c2, key)
    e, g = jax.value_and_grad(energy_fn)(x)
    f = -g
    v = v + 0.5 * dt * f * inv_m                                    # B
    return MDState(x, v, f, e)


def langevin_trajectory(state: MDState, energy_fn, masses, dt: float,
                        temperature: float, friction: float, key,
                        n_steps: int):
    """n_steps of BAOAB Langevin; returns (final_state, kinetic energies).

    Runs the scan on a packed ``[N, 9]`` x|v|f carry (see
    :func:`make_packed_nve_chunk` for why)."""

    def body(carry, _):
        p, k = carry
        k, sub = jax.random.split(k)
        s = MDState(p[:, 0:3], p[:, 3:6], p[:, 6:9], 0.0)
        s = langevin_step(s, energy_fn, masses, dt, temperature, friction,
                          sub)
        p = jnp.concatenate([s.positions, s.velocities, s.forces], axis=1)
        return (p, k), kinetic_energy(s.velocities, masses)

    p0 = jnp.concatenate(
        [state.positions, state.velocities, state.forces], axis=1)
    (p, _), kes = jax.lax.scan(body, (p0, key), None, length=n_steps)
    x = p[:, 0:3]
    final = MDState(x, p[:, 3:6], p[:, 6:9], energy_fn(x))
    return final, kes


# ---------------------------------------------------------------------------
# FIRE energy minimization
# ---------------------------------------------------------------------------


def minimize_fire(positions, energy_fn, n_steps: int = 200, dt_start: float = 1e-4,
                  dt_max: float = 1e-3, alpha_start: float = 0.1):
    """FIRE (fast inertial relaxation engine) minimization; returns
    (positions, final_energy).  Entirely on-device (lax.scan)."""

    def force(x):
        return -jax.grad(energy_fn)(x)

    def body(carry, _):
        x, v, dt, alpha, n_pos = carry
        f = force(x)
        power = jnp.vdot(f, v)
        v_norm = jnp.sqrt(jnp.vdot(v, v)) + 1e-30
        f_norm = jnp.sqrt(jnp.vdot(f, f)) + 1e-30
        v_mixed = (1.0 - alpha) * v + alpha * (f / f_norm) * v_norm
        uphill = power < 0.0
        v_new = jnp.where(uphill, jnp.zeros_like(v), v_mixed)
        n_pos_new = jnp.where(uphill, 0, n_pos + 1)
        grow = (~uphill) & (n_pos > 5)
        dt_new = jnp.where(grow, jnp.minimum(dt * 1.1, dt_max),
                           jnp.where(uphill, dt * 0.5, dt))
        alpha_new = jnp.where(grow, alpha * 0.99,
                              jnp.where(uphill, alpha_start, alpha))
        v_next = v_new + dt_new * f
        x_next = x + dt_new * v_next
        return (x_next, v_next, dt_new, alpha_new, n_pos_new), None

    v0 = jnp.zeros_like(positions)
    init = (positions, v0, jnp.asarray(dt_start, positions.dtype),
            jnp.asarray(alpha_start, positions.dtype), jnp.asarray(0))
    (x, *_), _ = jax.lax.scan(body, init, None, length=n_steps)
    return x, energy_fn(x)


def remove_com_motion(velocities, masses) -> jax.Array:
    """Zero the center-of-mass momentum (OpenMM CMMotionRemover analog).

    Langevin/CSVR noise injects a random walk into the total momentum;
    call this between chunks (or on checkpoints) to keep the box from
    drifting.  NVE and RATTLE dynamics conserve momentum and never need
    it."""
    m = jnp.asarray(masses, velocities.dtype)
    p = jnp.sum(velocities * m[:, None], axis=0)
    return velocities - (p / jnp.sum(m))[None, :]
