"""Total energy and forces — the whole engine is one jit-compiled function.

Replaces the reference's kernel ``execute`` paths:

* non-periodic all-pairs + exclusion subtraction
  (ReferenceCoulKernels.cpp:436-499; CUDA noPBCForce.cu)
* periodic Ewald: self + reciprocal + direct erfc + exclusion correction
  (ReferenceCoulKernels.cpp:500-633; CUDA PBCForce.cu)

Forces: because q = q(x), F = -dE/dx - (dE/dq)(dq/dx) (README.md:57-65).
Here the *entire* force algorithm is ``jax.grad`` of E(q(x), x) — the chain
rule term the reference implements by hand (dedq accumulation + multdQdX,
ReferenceCoulKernels.cpp:493-499) is produced by autodiff.  A manual dedq
path (:func:`forces_manual`) mirrors the reference's algorithm explicitly and
is cross-checked against autodiff in tests (SURVEY §7: "the single strongest
whole-system test").

Exclusion contract (SURVEY §5): an excluded pair contributes no short-range
Coulomb and no LJ anywhere; under PBC it retains the reciprocal-space
correction −k_e q_i q_j erf(αr)/r, applied unconditionally (CPU semantics;
the GPU's within-cutoff variant differs only beyond the cutoff).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from . import cells
from .charges import apply_chain_rule, effective_charges
from .utils.profiling import phase_scope
from .ewald import reciprocal_energy, self_energy
from .ops.erfc import erf_over_r_eval, erfc_fast
from .pairs import box_volume, displacement, pair_matrix_mask, plane_widths
from .system import ChargeFluxSystem
from .units import ONE_4PI_EPS0


def dispersion_energy(box, spec, dtype):
    """Long-range LJ tail energy ``C / V`` (kJ/mol).

    ``C`` is the static coefficient precomputed at create_system
    (system.dispersion_tail_coefficient); the box is traced, so the term
    is position-independent (zero forces) but contributes the correct
    ``P_tail = C / V^2`` through the dE/ds virial route (npt.py) and the
    correct dE term to barostat volume moves.
    """
    return jnp.asarray(spec.tail_coeff, dtype) / box_volume(box)


def _lj_pair_terms(half_sig_sum, eps_prod, inv_r):
    """LJ energy in the reference's prefactored form: with s = 0.5*(si+sj)
    stored as the sum of half-sigmas and e = (2 sqrt(eps_i))(2 sqrt(eps_j)),
    E = e * s6 * (s6 - 1) == 4 eps_ij [ (sig/r)^12 - (sig/r)^6 ]
    (ReferenceCoulKernels.cpp:238-239, 442-451)."""
    sig2 = (half_sig_sum * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    return eps_prod * sig6 * (sig6 - 1.0)


def _dense_pair_energy(positions, q, system: ChargeFluxSystem):
    """Masked all-pairs short-range energy [scalar].

    noPBC: full 1/r Coulomb + LJ over all non-excluded pairs (no cutoff),
    matching ReferenceCoulKernels.cpp:438-462.
    PBC:   erfc_fast(alpha r)/r Coulomb + LJ over non-excluded pairs within the
    cutoff, matching the direct-space sum :562-593.
    """
    spec = system.spec
    n = positions.shape[0]
    pos_i = positions[:, None, :]
    pos_j = positions[None, :, :]
    d = displacement(pos_i, pos_j, system.box, spec.pbc)     # [N, N, 3]
    r2 = jnp.sum(d * d, axis=-1)
    mask = pair_matrix_mask(n, system.exclusions)
    if spec.pbc:
        mask = mask & (r2 < spec.cutoff * spec.cutoff)
    r2_safe = jnp.where(mask, r2, 1.0)
    inv_r = jax.lax.rsqrt(r2_safe)

    qq = q[:, None] * q[None, :]
    if spec.pbc:
        if positions.dtype == jnp.float64:
            coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(
                spec.alpha * (r2_safe * inv_r))
        else:
            # erfc(ar)/r = 1/r - P(r^2): exp/divide-free (ops/erfc.py)
            coul = ONE_4PI_EPS0 * qq * (
                inv_r - erf_over_r_eval(r2_safe, spec.alpha, spec.cutoff))
    else:
        coul = ONE_4PI_EPS0 * qq * inv_r

    half_sig = 0.5 * (system.sigma[:, None] + system.sigma[None, :])
    eps = 4.0 * jnp.sqrt(system.epsilon[:, None] * system.epsilon[None, :])
    lj = _lj_pair_terms(half_sig, eps, inv_r)
    return jnp.sum(jnp.where(mask, coul + lj, 0.0))


def _excl_pair_energy(r, inv_r, qq, half_sig, eps, spec, subtract_direct):
    """Per-pair exclusion correction: always -erf(ar)/r Coulomb; with
    ``subtract_direct`` also remove the erfc/r + LJ the in-cutoff direct walk
    counted."""
    erfc_ar = erfc_fast(spec.alpha * r)
    e = -ONE_4PI_EPS0 * qq * inv_r * (1.0 - erfc_ar)         # -erf(ar)/r
    if subtract_direct:
        in_cut = r < spec.cutoff
        direct = ONE_4PI_EPS0 * qq * inv_r * erfc_ar + _lj_pair_terms(half_sig, eps, inv_r)
        e = e - jnp.where(in_cut, direct, 0.0)
    return jnp.sum(e)


def _template_exclusion_correction(positions, q, system: ChargeFluxSystem,
                                   subtract_direct: bool):
    """Gather-free exclusion correction for templated blocks: atom data
    reshapes to [C, s] per block and pairs index molecule slots with static
    slices (same trick as charges._template_dq_flat); remainder rows (the
    solute's exclusions) are handled by the caller's general gather path."""
    spec = system.spec
    dtype = positions.dtype
    total = jnp.zeros((), dtype)
    for tpl in spec.excl_template.templates:
        off, s, c = tpl.offset, tpl.stride, tpl.count
        sl = slice(off, off + c * s)
        pos_m = positions[sl].reshape(c, s, 3)
        q_m = q[sl].reshape(c, s)
        sig_m = system.sigma[sl].astype(dtype).reshape(c, s)
        eps_m = system.epsilon[sl].astype(dtype).reshape(c, s)

        for (l1, l2) in tpl.local_rows("exclusions"):
            d = displacement(pos_m[:, l1], pos_m[:, l2], system.box,
                             spec.pbc)
            r2 = jnp.sum(d * d, axis=-1)
            inv_r = jax.lax.rsqrt(r2)
            r = r2 * inv_r
            qq = q_m[:, l1] * q_m[:, l2]
            half_sig = 0.5 * (sig_m[:, l1] + sig_m[:, l2])
            eps = 4.0 * jnp.sqrt(eps_m[:, l1] * eps_m[:, l2])
            total = total + _excl_pair_energy(r, inv_r, qq, half_sig, eps,
                                              spec, subtract_direct)
    return total


def _exclusion_correction(positions, q, system: ChargeFluxSystem,
                          subtract_direct: bool):
    """Energy correction for excluded pairs under PBC.

    Always: -k_e q_i q_j erf(alpha r)/r  (ReferenceCoulKernels.cpp:596-622,
    applied unconditionally on the CPU path).
    With ``subtract_direct`` (cell-list route, which — like the CUDA kernel
    with USE_EXCLUSIONS disabled, CudaCoulKernels.cpp:484 — computes erfc+LJ
    for *all* in-cutoff pairs): additionally remove erfc/r + LJ when
    r < cutoff, so the net excluded-pair contribution equals the contract.
    """
    if system.n_exclusions == 0:
        return jnp.zeros((), dtype=positions.dtype)
    spec = system.spec
    total = jnp.zeros((), dtype=positions.dtype)
    e0 = 0
    if spec.excl_template is not None:
        total = _template_exclusion_correction(positions, q, system,
                                               subtract_direct)
        e0 = spec.excl_template.covered("exclusions",
                                        system.exclusions.shape[0])
    if e0 < system.exclusions.shape[0]:
        # ONE fused gather for (x, q, sigma, eps) per pair end: per-column
        # gathers each break fusion into a separate kernel, and for
        # solute-sized remainders the kernel boundaries dominate
        dtype = positions.dtype
        idx_flat = system.exclusions[e0:].reshape(-1)        # [2E]
        table = jnp.concatenate(
            [positions, q[:, None], system.sigma.astype(dtype)[:, None],
             system.epsilon.astype(dtype)[:, None]], axis=1)  # [N, 6]
        ge = table[idx_flat].reshape(-1, 2, 6)
        d = displacement(ge[:, 0, 0:3], ge[:, 1, 0:3], system.box, spec.pbc)
        r2 = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(r2)
        inv_r = 1.0 / r
        qq = ge[:, 0, 3] * ge[:, 1, 3]
        half_sig = 0.5 * (ge[:, 0, 4] + ge[:, 1, 4])
        eps = 4.0 * jnp.sqrt(ge[:, 0, 5] * ge[:, 1, 5])
        total = total + _excl_pair_energy(r, inv_r, qq, half_sig, eps, spec,
                                          subtract_direct)
    return total


def resolve_recip_method(spec, dtype) -> str:
    """The reciprocal route an energy evaluation takes: ``"pme"`` or
    ``"xla"`` (classical Ewald).  The single-device engine and the halo
    route (parallel/halo.py) both ask here, so they cannot disagree.

    An explicit ``spec.recip_method`` stands.  ``"auto"`` picks PME for
    f32 on the cell route (the cell-blocked spread reuses the direct
    walk's blocks) and classical Ewald otherwise: f32 on the dense route
    (small boxes, where the k-space sum is a few GEMMs) and every f64
    evaluation (parity with the oracle's classical sum)."""
    if spec.recip_method != "auto":
        return spec.recip_method
    if (jnp.dtype(dtype) == jnp.float32 and spec.direct_method == "cell"
            and spec.pme_grid is not None):
        return "pme"
    return "xla"


def energy_components_fixed_charges(positions: jax.Array, q: jax.Array,
                                    system: ChargeFluxSystem,
                                    nb=None,
                                    include_recip: bool = True,
                                    ) -> Dict[str, jax.Array]:
    """Energy breakdown treating the effective charges as an independent
    input.  grad wrt ``q`` of the sum is exactly the reference's dedq vector
    (ReferenceCoulKernels.cpp:458-459, 509, 546, 588-589, 615-616).

    ``include_recip=False`` skips the reciprocal term entirely (for
    callers substituting their own k-space estimator, e.g. rbe.py —
    computing-then-discarding it would waste the whole PME/classical
    cost)."""
    spec = system.spec
    if not spec.pbc:
        return {"pair": _dense_pair_energy(positions, q, system)}

    comps: Dict[str, jax.Array] = {}
    comps["self"] = self_energy(q, spec.alpha)
    if spec.tail_coeff is not None:
        comps["dispersion"] = dispersion_energy(system.box, spec,
                                                positions.dtype)

    # -- direct space (builds the shared cell blocks when applicable) -------
    blocks = ids = None
    if spec.direct_method == "cell":
        with phase_scope("cf_binning"):
            if nb is None:
                slots, inv_slot, overflow = cells.build_cell_list_full(
                    positions, system.box, spec.cell_grid,
                    spec.cell_capacity)
                wrap = None
            else:
                slots, inv_slot, overflow = nb.slots, nb.inv_slot, nb.overflow
                wrap = nb.wrap
            blocks = cells.blockify(positions, q, system, slots, inv_slot,
                                    wrap=wrap)
        ids = slots.reshape(blocks.x.shape)
        with phase_scope("cf_direct"):
            e_dir = cells.direct_energy_on_blocks(blocks, ids, system)
        # In-jit overflow safety: a cell past capacity silently drops pair
        # interactions, so poison the energy — a density fluctuation mid-
        # trajectory becomes a visible NaN, not a quietly wrong force.
        # The poison term touches EVERY position so the gradient of every
        # atom (including the dropped ones, which get no direct-term
        # cotangent at all) is NaN too — a where() on the energy alone
        # leaves force-only consumers quietly wrong.
        # Traced-box (barostat, system.with_box) safety: the static grid
        # was sized for the creation-time box; if the box shrinks until a
        # cell plane spacing is below the cutoff, the half-shell walk
        # misses pairs.  (Plane spacing == edge for an orthorhombic box.)
        edge = (plane_widths(system.box)
                / jnp.asarray(spec.cell_grid, positions.dtype))
        bad = (overflow > 0) | jnp.any(edge < spec.cutoff)
        if nb is not None and (
                resolve_recip_method(spec, positions.dtype) == "pme"):
            # PME patch-slack safety under the traced box: pme_slack was
            # sized from the CREATION-time skin (system.py), but drift
            # between rebuilds is bounded by the CURRENT skin/2 — under
            # barostat growth the allowed drift outgrows the static
            # patch headroom and outermost B-spline taps would silently
            # truncate.  Poison when the *actual* drift since the rebuild
            # exceeds the slack budget in current mesh units (exact, not
            # the conservative possible-drift bound: an unmoved system in
            # a grown box stays valid).
            h = (plane_widths(system.box)
                 / jnp.asarray(np.asarray(spec.pme_grid), positions.dtype))
            budget = jnp.min(
                jnp.asarray(np.asarray(spec.pme_slack), positions.dtype)
                * h)
            d = positions - nb.x_ref
            max_d2 = jnp.max(jnp.sum(d * d, axis=-1))
            bad = bad | (max_d2 > budget * budget)
        poison = jnp.where(bad, jnp.asarray(jnp.nan, e_dir.dtype), 0.0)
        e_dir = e_dir + poison * jnp.sum(positions)
        comps["direct"] = e_dir
        with phase_scope("cf_exclusion"):
            comps["exclusion"] = _exclusion_correction(
                positions, q, system, subtract_direct=True)
    else:
        with phase_scope("cf_direct"):
            comps["direct"] = _dense_pair_energy(positions, q, system)
        with phase_scope("cf_exclusion"):
            comps["exclusion"] = _exclusion_correction(
                positions, q, system, subtract_direct=False)

    # -- reciprocal space ----------------------------------------------------
    if not include_recip:
        return comps
    recip_method = resolve_recip_method(spec, positions.dtype)
    with phase_scope("cf_reciprocal"):
        if recip_method == "pme":
            from .pme import pme_cell_reciprocal_energy, pme_reciprocal_energy

            if blocks is not None:
                comps["reciprocal"] = pme_cell_reciprocal_energy(
                    blocks, ids, system)
            else:
                comps["reciprocal"] = pme_reciprocal_energy(
                    positions, q, system.box, spec.alpha, spec.pme_grid,
                    spec.pme_order)
        else:
            comps["reciprocal"] = reciprocal_energy(positions, q, system.box,
                                                    spec.alpha, spec.kmax)
    return comps


def energy_fixed_charges(positions, q, system, nb=None) -> jax.Array:
    total = 0.0
    for v in energy_components_fixed_charges(positions, q, system,
                                             nb=nb).values():
        total = total + v
    return total


def _energy_components(positions, system) -> Dict[str, jax.Array]:
    """Energy breakdown with effective charges: {self, [dispersion,]
    reciprocal, direct, exclusion} under PBC, {pair} otherwise."""
    q = effective_charges(positions, system)
    return energy_components_fixed_charges(positions, q, system)


def _energy(positions: jax.Array, system: ChargeFluxSystem,
            nb=None) -> jax.Array:
    """Total potential energy (kJ/mol) with geometry-dependent charges;
    ``nb`` is an optional reused neighbor state (neighbors.py)."""
    with phase_scope("cf_charges"):
        q = effective_charges(positions, system)
    return energy_fixed_charges(positions, q, system, nb=nb)


def _forces(positions, system):
    """F = -dE/dx including the charge-flux chain rule, via autodiff."""
    return -jax.grad(_energy)(positions, system)


def _energy_and_forces(positions, system, nb=None):
    """(energy, forces) in one fused value_and_grad pass."""
    e, g = jax.value_and_grad(_energy)(positions, system, nb)
    return e, -g


def _forces_manual(positions: jax.Array, system: ChargeFluxSystem) -> jax.Array:
    """Reference-algorithm force path: fixed-charge gradient + explicit
    dedq.dqdx chain rule over the analytic sparse Jacobian
    (ReferenceCoulKernels.cpp:493-499); equals :func:`forces` to 1e-12."""
    q = effective_charges(positions, system)
    gx, dedq = jax.grad(energy_fixed_charges, argnums=(0, 1))(positions, q, system)
    return -gx + apply_chain_rule(dedq, positions, system)


# Public API: jit-compiled by default.  The system pytree's StaticSpec is
# hashable metadata, so jit specializes per (shapes, spec) — the analog of the
# reference's per-system NVRTC kernel JIT (CudaCoulKernels.cpp:377-516).

#: Total potential energy (kJ/mol).
energy = jax.jit(_energy)

#: Energy breakdown {self, reciprocal, direct, exclusion} / {pair}.
energy_components = jax.jit(_energy_components)

#: F = -dE/dx including the charge-flux chain rule, via autodiff.
forces = jax.jit(_forces)

#: (energy, forces) in one fused pass.
energy_and_forces = jax.jit(_energy_and_forces)

#: Reference-algorithm force path: fixed-charge gradient + explicit
#: dedq * dqdx chain rule over the analytic sparse Jacobian
#: (ReferenceCoulKernels.cpp:493-499, calcChargeFlux.cu:291-313).
#: Mathematically identical to :func:`forces`; kept as the parity oracle for
#: the reference's algorithm and exercised in tests/test_grad.py.
forces_manual = jax.jit(_forces_manual)
