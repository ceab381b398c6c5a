"""Harmonic bonded potentials (bonds + angles).

The reference plugin computes *only* charge-flux electrostatics and relies on
OpenMM's host framework (SURVEY §1 L0) to supply bonded forces in a real
simulation.  A standalone engine must provide them, so flexible molecules
hold together in the NVE loop: E = 0.5 k (r - r0)^2 and 0.5 k (theta -
theta0)^2, with forces from jax.grad like everything else.

Like the flux terms (charges.py), bonded indices almost always repeat
per-molecule; ``BondedParams.create`` detects the template (topology.py) and
``bonded_energy`` then evaluates on [n_mol, atoms_per_mol, 3] reshapes with
static slices — no gathers/scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .pairs import displacement
from .topology import TemplateSet, detect_templates


def harmonic_bond_energy(positions, idx, k, r0, box, pbc):
    """0.5 * k * (|r12| - r0)^2 summed over bonds.  idx [B,2]."""
    if idx.shape[0] == 0:
        return jnp.zeros((), positions.dtype)
    d = displacement(positions[idx[:, 0]], positions[idx[:, 1]], box, pbc)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    return 0.5 * jnp.sum(k * (r - r0) ** 2)


def harmonic_angle_energy(positions, idx, k, theta0, box, pbc):
    """0.5 * k * (theta - theta0)^2 over angles 1-2-3 (2 is the vertex)."""
    if idx.shape[0] == 0:
        return jnp.zeros((), positions.dtype)
    d21 = displacement(positions[idx[:, 1]], positions[idx[:, 0]], box, pbc)
    d23 = displacement(positions[idx[:, 1]], positions[idx[:, 2]], box, pbc)
    r21 = jnp.sqrt(jnp.sum(d21 * d21, axis=-1))
    r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
    cost = jnp.sum(d21 * d23, axis=-1) / (r21 * r23)
    theta = jnp.arccos(jnp.clip(cost, -1.0, 1.0))
    return 0.5 * jnp.sum(k * (theta - theta0) ** 2)


def periodic_torsion_energy(positions, idx, k, n, phi0, box, pbc):
    """``sum k (1 + cos(n phi - phi0))`` — OpenMM PeriodicTorsionForce
    convention: atoms 1-2-3-4, ``phi`` the dihedral about the 2-3 bond,
    computed with the atan2 formulation (stable at phi -> 0/pi, unlike
    acos of the plane-normal cosine).  idx [T, 4]; n is the integer
    periodicity; forces come from jax.grad like every other term."""
    if idx.shape[0] == 0:
        return jnp.zeros((), positions.dtype)
    p = [positions[idx[:, c]] for c in range(4)]
    b1 = displacement(p[0], p[1], box, pbc)
    b2 = displacement(p[1], p[2], box, pbc)
    b3 = displacement(p[2], p[3], box, pbc)
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    b2n = b2 / jnp.linalg.norm(b2, axis=-1, keepdims=True)
    m1 = jnp.cross(b2n, n1)     # order fixes the IUPAC sign (phi > 0 for
    cos_c = jnp.sum(n1 * n2, axis=-1)   # a clockwise far-bond viewed 2->3)
    sin_c = jnp.sum(m1 * n2, axis=-1)
    phi = jnp.arctan2(sin_c, cos_c)
    return jnp.sum(k * (1.0 + jnp.cos(n * phi - phi0)))


def _template_bonded_energy(positions, bonded) -> jax.Array:
    """Gather-free bonded energy via the molecule templates (static slices;
    same formulas as the general path above).  Returns (energy, covered
    bond rows, covered angle rows); the caller runs the gather path on the
    remainder tails."""
    box, pbc = bonded.box, bonded.pbc
    e = jnp.zeros((), positions.dtype)
    b_start = a_start = 0
    for tpl in bonded.template.templates:
        off, s, c = tpl.offset, tpl.stride, tpl.count
        pos_m = positions[off:off + c * s].reshape(c, s, 3)
        p = [pos_m[:, l] for l in range(s)]

        rows = tpl.local_rows("bonds")
        if rows:
            m = len(rows)
            k = bonded.bond_k[b_start:b_start + c * m].reshape(c, m)
            r0 = bonded.bond_r0[b_start:b_start + c * m].reshape(c, m)
            b_start += c * m
            for t, (l1, l2) in enumerate(rows):
                d = displacement(p[l1], p[l2], box, pbc)
                r = jnp.sqrt(jnp.sum(d * d, axis=-1))
                e = e + 0.5 * jnp.sum(k[:, t] * (r - r0[:, t]) ** 2)

        rows = tpl.local_rows("angles")
        if rows:
            m = len(rows)
            k = bonded.angle_k[a_start:a_start + c * m].reshape(c, m)
            t0 = bonded.angle_theta0[a_start:a_start + c * m].reshape(c, m)
            a_start += c * m
            for t, (l1, l2, l3) in enumerate(rows):
                d21 = displacement(p[l2], p[l1], box, pbc)
                d23 = displacement(p[l2], p[l3], box, pbc)
                r21 = jnp.sqrt(jnp.sum(d21 * d21, axis=-1))
                r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
                cost = jnp.sum(d21 * d23, axis=-1) / (r21 * r23)
                theta = jnp.arccos(jnp.clip(cost, -1.0, 1.0))
                e = e + 0.5 * jnp.sum(k[:, t] * (theta - t0[:, t]) ** 2)
    return e, b_start, a_start


def bonded_energy(positions: jax.Array, bonded: "BondedParams") -> jax.Array:
    b0 = a0 = 0
    e = jnp.zeros((), positions.dtype)
    if bonded.template is not None:
        e, b0, a0 = _template_bonded_energy(positions, bonded)
    n_b = bonded.bond_idx.shape[0] - b0
    n_a = bonded.angle_idx.shape[0] - a0
    if n_b + n_a > 0:
        # remainder bonds+angles share ONE position gather: per-kind
        # gathers each break fusion into separate kernels whose boundary
        # overhead dominates at solute sizes
        bi = bonded.bond_idx[b0:]
        ai = bonded.angle_idx[a0:]
        p_all = positions[jnp.concatenate([bi.reshape(-1),
                                           ai.reshape(-1)])]
        if n_b:
            pb = p_all[:2 * n_b].reshape(n_b, 2, 3)
            d = displacement(pb[:, 0], pb[:, 1], bonded.box, bonded.pbc)
            r = jnp.sqrt(jnp.sum(d * d, axis=-1))
            e = e + 0.5 * jnp.sum(bonded.bond_k[b0:]
                                  * (r - bonded.bond_r0[b0:]) ** 2)
        if n_a:
            pa = p_all[2 * n_b:].reshape(n_a, 3, 3)
            d21 = displacement(pa[:, 1], pa[:, 0], bonded.box, bonded.pbc)
            d23 = displacement(pa[:, 1], pa[:, 2], bonded.box, bonded.pbc)
            r21 = jnp.sqrt(jnp.sum(d21 * d21, axis=-1))
            r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
            cost = jnp.sum(d21 * d23, axis=-1) / (r21 * r23)
            theta = jnp.arccos(jnp.clip(cost, -1.0, 1.0))
            e = e + 0.5 * jnp.sum(bonded.angle_k[a0:]
                                  * (theta - bonded.angle_theta0[a0:]) ** 2)
    if bonded.torsion_idx is not None:
        # general (gather) path: torsion counts are small and water-family
        # systems have none — not worth a template fast path
        e = e + periodic_torsion_energy(
            positions, bonded.torsion_idx, bonded.torsion_k,
            bonded.torsion_n, bonded.torsion_phi0, bonded.box, bonded.pbc)
    return e


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BondedParams:
    """Bonded-term parameter pytree (companion to ChargeFluxSystem)."""

    bond_idx: jax.Array      # [B, 2] int32
    bond_k: jax.Array        # [B] kJ/mol/nm^2
    bond_r0: jax.Array       # [B] nm
    angle_idx: jax.Array     # [A, 3] int32 (vertex = column 1)
    angle_k: jax.Array       # [A] kJ/mol/rad^2
    angle_theta0: jax.Array  # [A] rad
    box: jax.Array           # [3]
    pbc: bool = dataclasses.field(metadata=dict(static=True))
    # periodic torsions (OpenMM PeriodicTorsionForce): optional, no
    # template fast path (counts are small; see bonded_energy)
    torsion_idx: Optional[jax.Array] = None    # [T, 4] int32
    torsion_k: Optional[jax.Array] = None      # [T] kJ/mol
    torsion_n: Optional[jax.Array] = None      # [T] periodicity
    torsion_phi0: Optional[jax.Array] = None   # [T] rad
    template: Optional[TemplateSet] = dataclasses.field(
        default=None, metadata=dict(static=True))

    @classmethod
    def create(cls, bond_idx, bond_k, bond_r0, angle_idx, angle_k,
               angle_theta0, box, pbc, n_atoms=None,
               torsion_idx=None, torsion_k=None, torsion_n=None,
               torsion_phi0=None, dtype=None) -> "BondedParams":
        """Build with molecule-template detection: when the index structure
        repeats per molecule, term arrays are reordered molecule-major and
        the fast static-slice path is used."""
        bond_idx = np.asarray(bond_idx, np.int64).reshape(-1, 2)
        angle_idx = np.asarray(angle_idx, np.int64).reshape(-1, 3)
        template = None
        if n_atoms is None:
            tops = [int(v.max()) + 1 for v in (bond_idx, angle_idx)
                    if v.size]
            n_atoms = max(tops) if tops else 0
        det = detect_templates({"bonds": bond_idx, "angles": angle_idx},
                               n_atoms=n_atoms) if n_atoms else None
        bond_k = np.asarray(bond_k)
        bond_r0 = np.asarray(bond_r0)
        angle_k = np.asarray(angle_k)
        angle_theta0 = np.asarray(angle_theta0)
        if det is not None:
            template, perms = det
            bp, ap = perms["bonds"], perms["angles"]
            bond_idx, bond_k, bond_r0 = bond_idx[bp], bond_k[bp], bond_r0[bp]
            angle_idx, angle_k, angle_theta0 = (angle_idx[ap], angle_k[ap],
                                                angle_theta0[ap])
        if dtype is None:
            dtype = jnp.float32
        tor = {}
        if torsion_idx is not None:
            tor = dict(
                torsion_idx=jnp.asarray(
                    np.asarray(torsion_idx, np.int64).reshape(-1, 4),
                    jnp.int32),
                torsion_k=jnp.asarray(torsion_k, dtype),
                torsion_n=jnp.asarray(torsion_n, dtype),
                torsion_phi0=jnp.asarray(torsion_phi0, dtype),
            )
        return cls(
            bond_idx=jnp.asarray(bond_idx, jnp.int32),
            bond_k=jnp.asarray(bond_k, dtype),
            bond_r0=jnp.asarray(bond_r0, dtype),
            angle_idx=jnp.asarray(angle_idx, jnp.int32),
            angle_k=jnp.asarray(angle_k, dtype),
            angle_theta0=jnp.asarray(angle_theta0, dtype),
            box=jnp.asarray(box, dtype),
            pbc=pbc,
            template=template,
            **tor,
        )


def position_restraint_energy(positions, idx, k, x0) -> jax.Array:
    """Harmonic position restraints: ``E = sum 0.5 k_i |x[idx_i] - x0_i|^2``
    (the OpenMM ``CustomExternalForce('0.5*k*periodicdistance(...)^2')``
    equilibration staple — the reference relies on its host framework for
    restraints, SURVEY §1 L0).  Absolute-space (no minimum image): a
    restraint pins a lab-frame site, so x0 should live in the same
    unwrapped frame as the trajectory.  ``idx`` [R] int, ``k`` [R] or
    scalar (kJ/mol/nm^2), ``x0`` [R, 3]."""
    d = positions[idx] - x0
    return 0.5 * jnp.sum(jnp.asarray(k) * jnp.sum(d * d, axis=-1))


def flat_bottom_restraint_energy(positions, idx, k, x0,
                                 radius) -> jax.Array:
    """Flat-bottom position restraints: zero inside ``radius``, harmonic
    in the overshoot outside — ``E = sum 0.5 k_i max(0, |d_i| - r_i)^2``.
    The standard pocket/backbone restraint; grad-safe at |d| = 0 (the
    double-where trick keeps the sqrt branch finite)."""
    d = positions[idx] - x0
    r2 = jnp.sum(d * d, axis=-1)
    nonzero = r2 > 0
    r = jnp.sqrt(jnp.where(nonzero, r2, 1.0))
    over = jnp.maximum(jnp.where(nonzero, r, 0.0) - jnp.asarray(radius),
                       0.0)
    return 0.5 * jnp.sum(jnp.asarray(k) * over * over)
