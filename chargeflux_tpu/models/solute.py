"""Solvated-solute model family: a bonded chain "mini-protein" in water.

The benchmark's hetero30k cell is a *solvated* box; the reference API is
topology-agnostic (CoulForce.h:137-149 — arbitrary particles, exclusions
and flux terms), so a real workload mixes one irregular solute with
thousands of identical waters.  This model builds exactly that shape:

- atoms [0, 3*n_solute_sites): a single covalent CHAIN (three ~0.1 nm
  spaced beads per occupied lattice site, consecutive beads bonded), with
  alternating partial charges, per-bond charge-flux terms and 1-2/1-3
  exclusions — ONE connected component far wider than
  topology.TEMPLATE_STRIDE_LIMIT, so every engine path must take the
  general gather/scatter route for it;
- the remaining lattice sites: flexible flux waters, which
  topology.detect_templates recovers as a molecule-template block at an
  offset, keeping the solvent majority gather-free.

Bond/angle rest geometry is taken from the *built* coordinates, so the
initial configuration starts near the bonded-energy minimum (the chain
walks the lattice serpentine; consecutive-site bead distances vary, and a
fixed r0 would start megajoules uphill).

Returns BondedParams-ready arrays (chain + waters) so MD drives the same
heterogeneous structure through bonded.py's template + remainder split.
"""

from __future__ import annotations

import numpy as np

from ..system import CoulForce
from .water import (ANGLE_HOH, EPS_H, EPS_O, KA_HOH, KB_OH, K_ANGLE,
                    K_BOND, Q_H, Q_O, R_OH, SIG_H, SIG_O, WATER_MASSES,
                    _one_water)

# Chain-bead parameters: small united-atom LJ, alternating +/- partial
# charges.  Sigma is kept WELL below the 0.095 nm bond length: the cell
# route computes erfc+LJ for all in-cutoff pairs and SUBTRACTS excluded
# ones (the CUDA-reference contract, PBCForce.cu:785-812), so an excluded
# pair deep inside sigma injects a huge compute-then-cancel term whose
# f64 roundoff would dominate parity tests (measured 3.8e-6 force noise
# at sigma 0.34 vs 0.095 nm bonds).
SIG_CH, EPS_CH, Q_CH, MASS_CH = 0.2, 0.1, 0.2, 12.011
K_FLUX_CHAIN = 0.4        # e/nm — charge flux per unit bond stretch
KB_CHAIN = 80000.0        # kJ/mol/nm^2 harmonic chain bond
KA_CHAIN = 250.0          # kJ/mol/rad^2 harmonic chain angle


def solvated_chain_box(n_side: int = 6, n_solute_sites: int = 8,
                       flux: str = "bond_angle", cutoff: float = 0.9,
                       ewald_tol: float = 1e-4,
                       density_spacing: float = 0.3107, seed: int = 0):
    """Periodic box: a 3*n_solute_sites-bead bonded chain solvated in
    (n_side^3 - n_solute_sites) flexible flux waters.

    Returns (force, positions [N, 3], masses [N], box [3], bonded_kw)
    where ``bonded_kw`` are ready-made keyword arrays for
    ``BondedParams.create`` covering the chain AND the waters.
    """
    n_sites = n_side ** 3
    if n_solute_sites >= n_sites:
        raise ValueError(f"{n_solute_sites} solute sites need a bigger box "
                         f"than {n_sites} lattice sites")
    if n_solute_sites < 1:
        raise ValueError("need at least one solute site")
    n_chain = 3 * n_solute_sites
    n_w = n_sites - n_solute_sites

    rng = np.random.default_rng(seed)
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(ewald_tol)
    box = np.full(3, n_side * density_spacing)

    # serpentine site walk: consecutive enumeration sites are lattice
    # neighbors, so the chain never makes long jumps
    sites = []
    for ix in range(n_side):
        ys = range(n_side) if ix % 2 == 0 else range(n_side - 1, -1, -1)
        for k, iy in enumerate(ys):
            zs = (range(n_side) if (ix * n_side + k) % 2 == 0
                  else range(n_side - 1, -1, -1))
            for iz in zs:
                sites.append((ix, iy, iz))
    centers = density_spacing * (np.asarray(sites, np.float64) + 0.5)

    # --- solute chain: 3 beads per site along the walk direction ---------
    pos = []
    for s in range(n_solute_sites):
        c = centers[s]
        step = (centers[s + 1] - c) if s + 1 < n_solute_sites else \
            np.array([0.0, 0.0, density_spacing])
        step = step / max(np.linalg.norm(step), 1e-9)
        for b in range(3):
            pos.append(c + step * 0.095 * (b - 1)
                       + 0.004 * rng.standard_normal(3))
    chain_pos = np.asarray(pos)

    for i in range(n_chain):
        force.addParticle(Q_CH if i % 2 == 0 else -Q_CH, SIG_CH, EPS_CH)
    # rest geometry from the built coordinates (near-equilibrium start)
    d = chain_pos[1:] - chain_pos[:-1]
    r0 = np.linalg.norm(d, axis=-1)
    theta0 = np.empty(max(n_chain - 2, 0))
    for i in range(n_chain - 2):
        a, b = -d[i], d[i + 1]
        cosv = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
        theta0[i] = np.arccos(np.clip(cosv, -1.0, 1.0))
    for i in range(n_chain - 1):
        force.addFluxBond(i, i + 1, K_FLUX_CHAIN, float(r0[i]))
        force.addException(i, i + 1)
    for i in range(n_chain - 2):
        force.addException(i, i + 2)

    chain_bond_idx = np.stack([np.arange(n_chain - 1),
                               np.arange(1, n_chain)], axis=1)
    chain_angle_idx = np.stack([np.arange(n_chain - 2),
                                np.arange(1, n_chain - 1),
                                np.arange(2, n_chain)], axis=1)

    # --- waters on the remaining sites -----------------------------------
    for w in range(n_w):
        o = force.addParticle(Q_O, SIG_O, EPS_O)
        h1 = force.addParticle(Q_H, SIG_H, EPS_H)
        h2 = force.addParticle(Q_H, SIG_H, EPS_H)
        force.addException(o, h1)
        force.addException(o, h2)
        force.addException(h1, h2)
        if flux == "bond_angle":
            force.addFluxBond(o, h1, K_BOND, R_OH)
            force.addFluxBond(o, h2, K_BOND, R_OH)
            force.addFluxAngle(h1, o, h2, K_ANGLE, ANGLE_HOH)
        elif flux != "none":
            raise ValueError(f"unknown flux mode {flux!r}")
        pos.append(_one_water(
            centers[n_solute_sites + w] + 0.01 * rng.standard_normal(3),
            rng))
    positions = np.concatenate(
        [chain_pos] + pos[n_chain:], axis=0) if n_w else chain_pos

    masses = np.concatenate([np.full(n_chain, MASS_CH),
                             np.tile(np.array(WATER_MASSES), n_w)])

    wbase = n_chain + 3 * np.arange(n_w)[:, None]
    bonded_kw = dict(
        bond_idx=np.concatenate(
            [chain_bond_idx, wbase + [0, 1], wbase + [0, 2]], axis=0),
        bond_k=np.concatenate(
            [np.full(n_chain - 1, KB_CHAIN), np.full(2 * n_w, KB_OH)]),
        bond_r0=np.concatenate([r0, np.full(2 * n_w, R_OH)]),
        angle_idx=np.concatenate([chain_angle_idx, wbase + [1, 0, 2]],
                                 axis=0),
        angle_k=np.concatenate(
            [np.full(max(n_chain - 2, 0), KA_CHAIN), np.full(n_w, KA_HOH)]),
        angle_theta0=np.concatenate([theta0, np.full(n_w, ANGLE_HOH)]),
        n_atoms=n_chain + 3 * n_w,
    )
    return force, positions, masses, box, bonded_kw
