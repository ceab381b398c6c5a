"""Constant-pressure (NPT) support: molecule-scaled Monte Carlo barostat.

The reference plugin computes only charge-flux electrostatics and leaves
ensemble control to OpenMM's host framework (SURVEY §1 L0): its users run
NPT by attaching OpenMM's ``MonteCarloBarostat`` to the Context.  A
standalone engine must supply the equivalent, so this module implements the
same algorithm inside the jit program — isotropic volume moves that scale molecule
*centroids* (intramolecular geometry untouched), Metropolis acceptance with
the NPT weight ``W = dE + P dV - N_mol kT ln(V'/V)``, and a Langevin
(BAOAB) driver that interleaves attempts with MD chunks.  The whole
trajectory is one lax.scan program; the accept/reject is a ``where``-select
(no data-dependent ``lax.cond`` in the step, see
integrate.make_nb_energy_fn).

The key part: the box is a *traced leaf* of the system pytree
(``ChargeFluxSystem.with_box``), so a volume move re-uses the compiled
energy function — trace-time statics (alpha, kmax, PME grid, cell grid and
capacity) stay fixed.  They were derived for the creation-time box, so the
cell route NaN-poisons the energy if the box shrinks below ``grid*cutoff``
validity (energy.py) rather than silently missing pairs; the ~5%
Verlet-skin reserve in the grid sizing (system.py) is the shrink budget,
and the neighbor-freshness guard window tightens automatically as the box
shrinks (neighbors.skin_radius reads the traced box).

One deliberate deviation from OpenMM's barostat: the proposal width dV is
adapted *continuously* (x1.03 on accept, /1.03 on reject, clamped) instead
of in blocks of 10 attempts — a per-attempt update keeps the adaptation
inside the scan carry with no host round-trips and converges to the same
~50% acceptance.

Scope: single-device (or vmap-replica) trajectories by default.  NPT over
a halo-sharded system: pass ``energy_fn=make_halo_energy_fn(
system, mesh)`` — slab ownership is fractional so volume moves never
re-partition atoms, and the halo route carries the same traced-box
grid-validity NaN guard as the single-chip cell path; the driver then
evaluates electrostatics through ``energy_fn(x, box)`` (fresh 1/D-sharded
binning every step — no neighbor-state reuse, which is what makes the
composition exact) while bonded terms stay replicated.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from .bonded import bonded_energy
from .energy import _energy
from .integrate import (baoab_coeffs, baoab_pre_force, kinetic_energy,
                        x_into_energy)
from .pairs import box_volume, displacement
from .units import BOLTZ

# 1 bar in kJ/mol/nm^3: 1e5 J/m^3 x 1e-27 m^3/nm^3 x N_A.
BAR_TO_KJ_MOL_NM3 = 0.0602214076


def molecule_index(system, extra_idx: tuple = ()):
    """Molecule assignment from the system's own connectivity (host-side,
    static): connected components of the union of the exclusion graph and
    the flux-term index rows (plus any ``extra_idx`` [*, k] arrays, e.g.
    bonded indices).  The reference's exclusion list is exactly its bonded
    connectivity contract (SURVEY §0), so its components are the molecules.

    Returns ``(mol_id [N] int32, first_idx [M] int32, counts [M] f64)``:
    per-atom molecule id, the first atom of each molecule (the centroid
    reference for minimum-image unwrapping), and atoms per molecule.
    """
    n = system.n_atoms
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    groups = [np.asarray(system.exclusions).reshape(-1, 2),
              np.asarray(system.bond_idx).reshape(-1, 2),
              np.asarray(system.angle_idx).reshape(-1, 3),
              np.asarray(system.water_idx).reshape(-1, 3)]
    # empty extras are legal (e.g. a torsion-only BondedParams' bond_idx)
    groups += [np.asarray(g).reshape(-1, np.asarray(g).shape[-1])
               for g in extra_idx if np.asarray(g).size]
    for arr in groups:
        for row in arr:
            r0 = find(int(row[0]))
            for a in row[1:]:
                ra = find(int(a))
                if ra != r0:
                    parent[ra] = r0
    roots = np.fromiter((find(i) for i in range(n)), np.int64, n)
    _, mol_id, counts = np.unique(roots, return_inverse=True,
                                  return_counts=True)
    m = counts.shape[0]
    first_idx = np.full(m, n, np.int64)
    np.minimum.at(first_idx, mol_id, np.arange(n))
    return (mol_id.astype(np.int32), first_idx.astype(np.int32),
            counts.astype(np.float64))


def molecule_centroids(x, box, mol_id, first_idx, counts):
    """Geometric molecule centers, minimum-imaged around each molecule's
    first atom so molecules straddling the periodic boundary scale as one
    unit (positions themselves may be unwrapped; the engine never wraps)."""
    ref = x[first_idx]                                   # [M, 3]
    d = displacement(ref[mol_id], x, box, pbc=True)      # x - ref, min-image
    sums = jax.ops.segment_sum(d, jnp.asarray(mol_id),
                               num_segments=first_idx.shape[0])
    return ref + sums / jnp.asarray(counts, x.dtype)[:, None]


def instantaneous_pressure(positions, velocities, system, masses,
                           bonded=None) -> jax.Array:
    """Instantaneous internal pressure in bar, from the full virial.

    Formulation: instead of accumulating per-pair ``r·f`` terms
    through every kernel (the classic approach, which would need plumbing
    through the direct walk, PME, exclusions and flux chain rule), take
    ``dE/ds`` of the *uniformly scaled* configuration — positions and the
    traced box both scaled by ``s`` (``system.with_box``) — by autodiff at
    ``s = 1``.  For any E built from scale-covariant terms (pair distances,
    Ewald k-vectors ``2 pi n / L``, volumes) this is exactly the virial:
    ``P = (2 K - dE/ds) / (3 V)``.  One extra backward pass; no kernel
    changes.

    Accuracy note (measured, tests/test_npt.py): the virial amplifies the
    Ewald *truncation* error ~100x relative to the energy — the missing
    k-space/real-space tails' s-derivative carries the large
    ``(pi kmax / (L alpha))^2`` exponent factor.  For pressures good to
    ~0.1% build the system with ``ewald_tol <= 1e-6``; the default 1e-4
    gives ~10% virial error on a 216-water box (fine for trends, not for
    equations of state).

    On the cell route this differentiates the *plain-autodiff* assembly
    (roll walk + classical reciprocal at the spec's kmax) rather than the
    MD path's fused custom-VJP walk, whose hand backward defines
    position/charge cotangents only — box cotangents would bloat the hot
    kernel for the sake of an occasional observable.  Same physics, same
    truncation family, slower backward (fine off the step path).
    """
    dtype = positions.dtype

    def e_scaled(s):
        return _box_grad_potential(positions * s,
                                   system.with_box(system.box * s),
                                   system, bonded)

    de_ds = jax.grad(e_scaled)(jnp.asarray(1.0, dtype))
    vol = box_volume(system.box)
    ke = kinetic_energy(velocities, masses)
    p_internal = (2.0 * ke - de_ds) / (3.0 * vol)    # kJ/mol/nm^3
    return p_internal / BAR_TO_KJ_MOL_NM3


def _box_grad_potential(xs, sysb, system, bonded):
    """Potential assembly safe to differentiate through the *box*: the
    plain-autodiff cell/classical paths (the MD path's fused custom-VJP
    walk defines position/charge cotangents only — see
    instantaneous_pressure's accuracy note)."""
    spec = system.spec
    if spec.pbc and spec.direct_method == "cell":
        from .cells import cell_roll_direct_energy
        from .charges import effective_charges
        from .energy import _exclusion_correction
        from .ewald import reciprocal_energy, self_energy
        q = effective_charges(xs, sysb)
        e = (self_energy(q, spec.alpha)
             + _exclusion_correction(xs, q, sysb, subtract_direct=True)
             + cell_roll_direct_energy(xs, q, sysb)
             + reciprocal_energy(xs, q, sysb.box, spec.alpha, spec.kmax))
        if spec.tail_coeff is not None:
            from .energy import dispersion_energy
            e = e + dispersion_energy(sysb.box, spec, xs.dtype)
    else:
        e = _energy(xs, sysb)
    if bonded is not None:
        e = e + bonded_energy(xs, dataclasses.replace(
            bonded, box=jnp.asarray(sysb.box, bonded.box.dtype)))
    return e


def pressure_tensor(positions, velocities, system, masses,
                    bonded=None) -> jax.Array:
    """Instantaneous internal pressure TENSOR [3, 3] in bar (the per-axis
    observable behind the anisotropic barostat; its trace/3 is
    :func:`instantaneous_pressure` up to the same Ewald-truncation
    caveat).

    Strain-derivative formulation (no per-kernel virial plumbing): deform positions and lattice rows by ``F = I + tril(eps)``
    (lower-triangular strain keeps a reduced lattice lower-triangular, so
    every traced triclinic code path stays valid) and autodiff at
    ``eps = 0``:

        P_ab V = sum_i m_i v_ia v_ib - dE/d eps_ab .

    The Cauchy stress of a rotation-invariant potential is symmetric, so
    the lower triangle determines the tensor; the result is mirrored to
    full symmetric form.  Same accuracy note as
    :func:`instantaneous_pressure`: build with ``ewald_tol <= 1e-6`` for
    quantitative stress.
    """
    dtype = positions.dtype
    box0 = system.box
    b_mat = jnp.diag(box0) if box0.ndim == 1 else box0

    hp = jax.lax.Precision.HIGHEST   # f32 dots on an observable path

    def e_strained(eps):
        f = jnp.eye(3, dtype=dtype) + jnp.tril(eps)
        return _box_grad_potential(jnp.matmul(positions, f, precision=hp),
                                   system.with_box(
                                       jnp.matmul(b_mat, f, precision=hp)),
                                   system, bonded)

    de = jax.grad(e_strained)(jnp.zeros((3, 3), dtype))
    v = jnp.asarray(velocities, dtype)
    m = jnp.asarray(masses, dtype)
    kin = jnp.einsum("i,ia,ib->ab", m, v, v, precision=hp)
    p_l = kin - de                                   # lower triangle valid
    p_sym = jnp.tril(p_l) + jnp.tril(p_l, -1).T
    return p_sym / (box_volume(box0) * BAR_TO_KJ_MOL_NM3)


def _npt_langevin_driver(positions, velocities, system, masses,
                         dt: float, temperature: float, friction: float,
                         key, n_steps: int, bonded,
                         barostat_interval: int, make_attempt, dv0,
                         constraints=None, energy_fn=None):
    """Shared NPT machinery: BAOAB chunks at fixed box + one barostat
    attempt per chunk, all in one lax.scan.  ``make_attempt(e_pot)``
    returns ``attempt(x, box, dv, e_old, k) -> (x, box, dv, e_cur, ok,
    poisoned, extras)`` — the proposal/acceptance policy (isotropic or
    anisotropic); ``dv0`` is its initial adaptive proposal width (scalar
    or per-axis).  ``constraints`` (a constraints.RigidWaterParams)
    switches the MD chunk to RATTLE-projected BAOAB — the barostat move
    itself needs no projection because molecule-centroid scaling
    translates each molecule rigidly."""
    n_outer, rem = divmod(n_steps, barostat_interval)
    if rem or n_outer == 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "barostat_interval")

    from .neighbors import build_neighbor_state, neighbor_state_fresh

    # An external electrostatics evaluator (e.g. the halo-sharded energy,
    # parallel/halo.py) evaluates e(x, box) directly: it re-bins fresh on
    # every call (its own overflow/grid-validity NaN guards apply), so the
    # neighbor-state reuse + freshness-guard machinery below is bypassed.
    has_cells = system.spec.direct_method == "cell" and energy_fn is None
    if has_cells:
        # the neighbor state is rebuilt once per chunk, so the barostat
        # interval doubles as the rebuild interval — warn if that outruns
        # the skin budget (the guard would NaN-poison, visibly but fatally)
        from .neighbors import suggest_rebuild_interval
        safe = suggest_rebuild_interval(system, dt, cap=barostat_interval)
        if safe < barostat_interval:
            import warnings
            warnings.warn(
                f"barostat_interval {barostat_interval} exceeds the "
                f"skin-safe rebuild interval {safe} at dt={dt}; the "
                "freshness guard will NaN-poison the trajectory if atom "
                "displacement outruns the skin — use a smaller interval")
    dtype = positions.dtype
    inv_m = (1.0 / jnp.asarray(masses, dtype))[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature, dtype)

    def e_pot(xx, box, nb=None):
        if energy_fn is not None:
            e = energy_fn(xx, box)
        else:
            sb = system.with_box(box)
            e = _energy(xx, sb, nb=nb)
        if bonded is not None:
            e = e + bonded_energy(xx, dataclasses.replace(
                bonded, box=jnp.asarray(box, bonded.box.dtype)))
        return e

    attempt = make_attempt(e_pot)

    if constraints is not None:
        from .constraints import project_positions, project_velocities

    def chunk(xx, vv, box, k):
        """barostat_interval BAOAB steps at fixed box with one nb build."""
        sb = system.with_box(box)
        nb = (jax.lax.stop_gradient(build_neighbor_state(xx, sb))
              if has_cells else None)

        def e_of(z):
            return e_pot(z, box, nb=nb)

        # fresh forces at the chunk head (the box may just have moved)
        _, g0 = jax.value_and_grad(e_of)(xx)

        def guarded_force(x):
            e, g = jax.value_and_grad(e_of)(x)
            if has_cells:
                bad = jnp.where(neighbor_state_fresh(nb, x, sb), 1.0,
                                jnp.asarray(jnp.nan, e.dtype))
                e = e * bad
                g = g * bad
            return e, -g

        # packed [N, 9] x|v|f carry, same rationale as
        # integrate.make_packed_nve_chunk (three separate [N, 3] carries
        # may each be relayouted at the loop boundary); the positions handed to the force closure go through x_into_energy.
        if constraints is None:
            def body(p, kk):
                x, v, f = p[:, 0:3], p[:, 3:6], p[:, 6:9]
                x, v = baoab_pre_force(x, v, f, inv_m, dt, c1, c2, kk)
                e, f = guarded_force(x_into_energy(x))
                v = v + 0.5 * dt * f * inv_m                        # B
                return (jnp.concatenate([x, v, f], axis=1),
                        (e, e + kinetic_energy(v, masses)))
        else:
            def a_half(x, v):
                x_new = project_positions(x, x + 0.5 * dt * v, constraints)
                return x_new, (x_new - x) / (0.5 * dt)

            def body(p, kk):
                x, v, f = p[:, 0:3], p[:, 3:6], p[:, 6:9]
                v = project_velocities(x, v + 0.5 * dt * f * inv_m,
                                       constraints)                 # B
                x, v = a_half(x, v)                                 # A
                noise = jax.random.normal(kk, v.shape, dtype=v.dtype)
                v = project_velocities(
                    x, c1 * v + c2 * jnp.sqrt(inv_m) * noise,
                    constraints)                                    # O
                x, v = a_half(x, v)                                 # A
                e, f = guarded_force(x_into_energy(x))
                v = project_velocities(x, v + 0.5 * dt * f * inv_m,
                                       constraints)                 # B
                return (jnp.concatenate([x, v, f], axis=1),
                        (e, e + kinetic_energy(v, masses)))

        keys = jax.random.split(k, barostat_interval)
        p0 = jnp.concatenate([xx, vv, -g0], axis=1)
        p, (es, etot) = jax.lax.scan(body, p0, keys)
        return p[:, 0:3], p[:, 3:6], es[-1], etot

    def outer(carry, _):
        x, v, box, dv, e_cur, k = carry
        k, kb, kc = jax.random.split(k, 3)
        x, box, dv, e_cur, ok, poisoned, extras = attempt(x, box, dv,
                                                          e_cur, kb)
        x, v, e_cur, etot = chunk(x, v, box, kc)
        return (x, v, box, dv, e_cur, k), (etot, box, ok, poisoned, extras)

    e0 = e_pot(positions, jnp.asarray(system.box, dtype))
    v_init = jnp.asarray(velocities, dtype)
    if constraints is not None:
        v_init = project_velocities(jnp.asarray(positions, dtype), v_init,
                                    constraints)
    carry0 = (jnp.asarray(positions, dtype), v_init,
              jnp.asarray(system.box, dtype), jnp.asarray(dv0, dtype),
              e0, key)
    (x, v, box, dv, _e, _k), (etot, boxes, accepts, poisoned, extras) = \
        jax.lax.scan(outer, carry0, None, length=n_outer)
    diag = {"energies": etot.reshape(-1), "boxes": boxes,
            "accepts": accepts, "poisoned": poisoned, "dv": dv}
    diag.update(extras)
    return x, v, box, diag


def npt_langevin_trajectory(positions, velocities, system, masses,
                            dt: float, temperature: float, friction: float,
                            pressure_bar: float, key, n_steps: int,
                            bonded=None, barostat_interval: int = 20,
                            dv_frac: float = 0.01,
                            extra_mol_idx: tuple = (),
                            constraints=None, energy_fn=None):
    """NPT via BAOAB Langevin dynamics + an isotropic MC barostat attempt
    every ``barostat_interval`` steps (n_steps must be a multiple of it).

    ``energy_fn(x, box)`` overrides the electrostatics evaluator — pass
    ``parallel.halo.make_halo_energy_fn(system, mesh)`` to run NPT over a
    halo-sharded device mesh (see the module docstring); bonded terms stay
    replicated and the barostat logic is unchanged.

    On the cell route the neighbor state is rebuilt once per chunk and
    reused inside (the same amortization as nve_trajectory_nb), with the
    freshness guard poisoning a too-long interval to NaN.  Returns
    ``(x, v, box, diag)`` with ``diag = {"energies" [n_steps] total E,
    "boxes" [n_attempts, ...], "accepts" [n_attempts] bool,
    "poisoned" [n_attempts] bool, "dv" scalar}``; ``poisoned`` marks
    proposals whose energy NaN-poisoned (cell overflow or grid-validity
    at the proposed box) — many of them means the equilibrium box is
    outside the static grid's validity and the run needs a recreated
    system (larger capacity / different grid), not more steps.
    """
    if bonded is not None and extra_mol_idx == ():
        extra_mol_idx = tuple(
            np.asarray(a) for a in (bonded.bond_idx, bonded.angle_idx,
                                    bonded.torsion_idx) if a is not None)
    mol_id, first_idx, counts = molecule_index(system, extra_mol_idx)
    n_mol = first_idx.shape[0]
    dtype = jnp.asarray(positions).dtype
    kt = BOLTZ * temperature
    p_int = pressure_bar * BAR_TO_KJ_MOL_NM3

    def make_attempt(e_pot):
        def attempt(xx, box, dv, e_old, k):
            ku, ka = jax.random.split(k)
            v0 = box_volume(box)
            dvol = dv * (2.0 * jax.random.uniform(ku, dtype=dtype) - 1.0)
            v1 = v0 + dvol
            s = jnp.cbrt(v1 / v0)
            c = molecule_centroids(xx, box, mol_id, first_idx, counts)
            x1 = xx + (s - 1.0) * c[mol_id]
            box1 = box * s
            e_new = e_pot(x1, box1)   # fresh binning at the proposed box
            w = (e_new - e_old + p_int * dvol
                 - n_mol * kt * jnp.log(v1 / v0))
            # NaN w (poisoned e_new: grid validity or overflow) compares
            # False
            ok = jax.random.uniform(ka, dtype=dtype) < jnp.exp(-w / kt)
            # a poisoned proposal must stay VISIBLE (CLAUDE.md invariant),
            # not melt into ordinary rejections — report it so a box pinned
            # at the static grid's validity bound is diagnosable from
            # diag["poisoned"]
            poisoned = ~jnp.isfinite(e_new)
            xx = jnp.where(ok, x1, xx)
            box = jnp.where(ok, box1, box)
            e_cur = jnp.where(ok, e_new, e_old)
            dv = jnp.clip(jnp.where(ok, dv * 1.03, dv / 1.03),
                          1e-5 * v0, 0.1 * v0)
            return xx, box, dv, e_cur, ok, poisoned, {}
        return attempt

    box0 = jnp.asarray(system.box, dtype)
    dv0 = jnp.asarray(dv_frac, dtype) * jnp.asarray(box_volume(box0), dtype)
    return _npt_langevin_driver(positions, velocities, system, masses, dt,
                                temperature, friction, key, n_steps, bonded,
                                barostat_interval, make_attempt, dv0,
                                constraints=constraints, energy_fn=energy_fn)


def npt_anisotropic_langevin_trajectory(
        positions, velocities, system, masses, dt: float,
        temperature: float, friction: float, pressure_bar: float, key,
        n_steps: int, bonded=None, barostat_interval: int = 20,
        dv_frac: float = 0.01, scale_axes=(True, True, True),
        extra_mol_idx: tuple = (), constraints=None, energy_fn=None):
    """NPT with an *anisotropic* MC barostat: each attempt scales ONE
    lattice axis (chosen uniformly among the ``scale_axes`` marked True),
    with an independently adapted proposal width per axis — the analog of
    OpenMM's MonteCarloAnisotropicBarostat, which the reference relies on
    its host framework for.  ``scale_axes=(True, True, False)`` gives the
    semi-isotropic membrane-style ensemble with a fixed z axis.

    Axis scaling is lattice-aware: scaling axis ``a`` scales lattice row
    ``B[a]`` and moves each molecule centroid by ``(s-1) f_a B[a]`` with
    ``f_a`` its fractional coordinate — for an orthorhombic box this is
    the familiar per-coordinate scaling, and for a triclinic box it
    preserves the reduced form (row rescaling keeps the lower-triangular
    structure; the off-diagonal reduced-form bounds shrink/grow with
    their diagonals only for axis 0, so extreme per-axis drift can in
    principle leave reduced form — recreate the system if diag reports
    persistent poisoning).  Acceptance weight, chunking, poison
    visibility and the diag layout match :func:`npt_langevin_trajectory`;
    ``diag["axes"]`` records the attempted axis per barostat attempt and
    ``diag["dv"]`` is the final [3] per-axis proposal width.
    """
    from .pairs import frac_coords

    allowed = np.array([a for a in range(3) if scale_axes[a]], np.int32)
    if allowed.size == 0:
        raise ValueError("scale_axes must enable at least one axis")
    if bonded is not None and extra_mol_idx == ():
        extra_mol_idx = tuple(
            np.asarray(a) for a in (bonded.bond_idx, bonded.angle_idx,
                                    bonded.torsion_idx) if a is not None)
    mol_id, first_idx, counts = molecule_index(system, extra_mol_idx)
    n_mol = first_idx.shape[0]
    dtype = jnp.asarray(positions).dtype
    kt = BOLTZ * temperature
    p_int = pressure_bar * BAR_TO_KJ_MOL_NM3

    def make_attempt(e_pot):
        def attempt(xx, box, dv, e_old, k):
            kx, ku, ka = jax.random.split(k, 3)
            ai = jax.random.randint(kx, (), 0, allowed.size)
            axis = jnp.asarray(allowed)[ai]
            onehot = (jnp.arange(3) == axis).astype(dtype)
            v0 = box_volume(box)
            dva = jnp.sum(dv * onehot)
            dvol = dva * (2.0 * jax.random.uniform(ku, dtype=dtype) - 1.0)
            v1 = v0 + dvol
            s = v1 / v0                       # single-axis scale factor
            c = molecule_centroids(xx, box, mol_id, first_idx, counts)
            fa = jnp.sum(frac_coords(c, box) * onehot, axis=-1)   # [M]
            if box.ndim == 2:
                row = jnp.sum(box * onehot[:, None], axis=0)      # B[a]
                box1 = box * (1.0 + (s - 1.0) * onehot)[:, None]
            else:
                row = onehot * box
                box1 = box * (1.0 + (s - 1.0) * onehot)
            x1 = xx + (s - 1.0) * fa[mol_id, None] * row[None, :]
            e_new = e_pot(x1, box1)
            w = (e_new - e_old + p_int * dvol
                 - n_mol * kt * jnp.log(v1 / v0))
            ok = jax.random.uniform(ka, dtype=dtype) < jnp.exp(-w / kt)
            poisoned = ~jnp.isfinite(e_new)
            xx = jnp.where(ok, x1, xx)
            box = jnp.where(ok, box1, box)
            e_cur = jnp.where(ok, e_new, e_old)
            dva_new = jnp.clip(jnp.where(ok, dva * 1.03, dva / 1.03),
                               1e-5 * v0, 0.1 * v0)
            dv = dv * (1.0 - onehot) + dva_new * onehot
            return xx, box, dv, e_cur, ok, poisoned, {"axes": axis}
        return attempt

    box0 = jnp.asarray(system.box, dtype)
    dv0 = (jnp.asarray(dv_frac, dtype)
           * jnp.asarray(box_volume(box0), dtype)
           * jnp.ones((3,), dtype))
    return _npt_langevin_driver(positions, velocities, system, masses, dt,
                                temperature, friction, key, n_steps, bonded,
                                barostat_interval, make_attempt, dv0,
                                constraints=constraints, energy_fn=energy_fn)
