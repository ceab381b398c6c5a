"""Flexible 3-site water systems with charge flux.

System builders for the benchmark ladder in bench.py (125-water cluster,
216-water Ewald box, 4k/30k/100k-atom boxes).  These are the "model family"
of this engine: TIP3P-like base charges and LJ, flexible geometry, and
charge-flux terms expressed either as per-bond/per-angle fluxes
(addFluxBond/addFluxAngle) or as the combined CFF 3-site water term
(addFluxWater) — the three flux term types of the reference API
(CoulForce.cpp:78-125).
"""

from __future__ import annotations

import numpy as np

from ..system import CoulForce

# TIP3P-flavored parameters (charges e, lengths nm, energies kJ/mol).
Q_O, Q_H = -0.834, 0.417
SIG_O, EPS_O = 0.31507, 0.6364
SIG_H, EPS_H = 0.1, 0.0
R_OH = 0.09572
ANGLE_HOH = 1.82421813  # 104.52 degrees in radians
R_HH = 2 * R_OH * np.sin(ANGLE_HOH / 2)

# Charge-flux couplings (e/nm and e/rad) — representative magnitudes.
K_BOND = 1.2
K_ANGLE = 0.12
K1_WATER, K2_WATER, KUB_WATER = 1.0, 0.4, -0.3

WATER_MASSES = (15.999, 1.008, 1.008)

# SPC/Fw-like flexible-water bonded constants (kJ/mol/nm^2, kJ/mol/rad^2).
KB_OH = 443153.0
KA_HOH = 317.6


def _one_water(center, rng, perturb: float = 0.02):
    """O/H1/H2 positions for one water with random orientation and a small
    geometry perturbation (so flux terms are nonzero; ``perturb=0`` gives
    the exact rigid geometry)."""
    # random rotation via QR of a Gaussian matrix
    m = rng.standard_normal((3, 3))
    qmat, r = np.linalg.qr(m)
    qmat *= np.sign(np.diag(r))
    d1 = R_OH * (1.0 + perturb * rng.standard_normal())
    d2 = R_OH * (1.0 + perturb * rng.standard_normal())
    ang = ANGLE_HOH * (1.0 + perturb * rng.standard_normal())
    h1 = np.array([d1, 0.0, 0.0])
    h2 = np.array([d2 * np.cos(ang), d2 * np.sin(ang), 0.0])
    o = np.zeros(3)
    pts = np.stack([o, h1, h2]) @ qmat.T
    return pts + center


def _build(force: CoulForce, n_waters: int, flux: str):
    for w in range(n_waters):
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
        elif flux == "water":
            force.addFluxWater(o, h1, h2, K1_WATER, K2_WATER, KUB_WATER,
                               R_OH, R_HH)
        elif flux != "none":
            raise ValueError(f"unknown flux mode {flux!r}")


def water_bonded_params(n_waters: int, box=None, dtype=None):
    """SPC/Fw-style harmonic bonds/angles holding each water together —
    the bonded terms OpenMM's host framework would supply around the
    reference plugin.  Returns a BondedParams pytree."""
    import jax.numpy as jnp

    from ..bonded import BondedParams

    if dtype is None:
        dtype = jnp.float32
    base = 3 * np.arange(n_waters)[:, None]
    bond_idx = np.concatenate([base + [0, 1], base + [0, 2]], axis=0)
    angle_idx = base + [1, 0, 2]
    n_b, n_a = 2 * n_waters, n_waters
    pbc = box is not None
    box_arr = np.asarray(box, dtype=np.float64) if pbc else np.zeros(3)
    return BondedParams.create(
        bond_idx=bond_idx,
        bond_k=np.full(n_b, KB_OH),
        bond_r0=np.full(n_b, R_OH),
        angle_idx=angle_idx,
        angle_k=np.full(n_a, KA_HOH),
        angle_theta0=np.full(n_a, ANGLE_HOH),
        box=box_arr,
        pbc=pbc,
        n_atoms=3 * n_waters,
        dtype=dtype,
    )


def rigid_water_box(n_side: int = 6, cutoff: float = 0.9,
                    ewald_tol: float = 1e-4, density_spacing: float = 0.3107,
                    seed: int = 0, dtype=None):
    """Periodic rigid-TIP3P box: exact R_OH / HOH geometry (on the
    constraint manifold), fixed charges (rigid geometry makes
    intramolecular flux constant, so no flux terms), same LJ/exclusion
    contract as the flexible boxes.

    Returns (force, positions, masses, box, constraint_params) where
    constraint_params feeds the RATTLE drivers in
    :mod:`chargeflux_tpu.constraints` — the rigid-solvent configuration
    OpenMM would run the reference plugin in at a 2 fs step.
    """
    import jax.numpy as jnp

    from ..constraints import RigidWaterParams

    rng = np.random.default_rng(seed)
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(ewald_tol)
    n_w = n_side ** 3
    _build(force, n_w, flux="none")
    box = np.full(3, n_side * density_spacing)
    pos = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = density_spacing * (np.array([ix, iy, iz]) + 0.5)
                center += 0.01 * rng.standard_normal(3)
                pos.append(_one_water(center, rng, perturb=0.0))
    positions = np.concatenate(pos, axis=0)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    params = RigidWaterParams.create(
        n_w, d_oh=R_OH, d_hh=float(R_HH), m_o=WATER_MASSES[0],
        m_h=WATER_MASSES[1], dtype=dtype or jnp.float64)
    return force, positions, masses, box, params


def water_cluster(n_side: int = 5, spacing: float = 0.31, flux: str = "bond_angle",
                  seed: int = 0, **system_kwargs):
    """Non-periodic n_side^3-water cluster on a jittered lattice.

    Returns (force, positions [3*n^3, 3], masses [3*n^3]).
    n_side=5 gives the 125-water cluster.
    """
    rng = np.random.default_rng(seed)
    force = CoulForce()
    n_w = n_side ** 3
    _build(force, n_w, flux)
    pos = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = spacing * np.array([ix, iy, iz], dtype=np.float64)
                center += 0.02 * rng.standard_normal(3)
                pos.append(_one_water(center, rng))
    positions = np.concatenate(pos, axis=0)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses


def water_system_from_pdb(path: str, flux: str = "bond_angle",
                          cutoff: float = 0.9, ewald_tol: float = 1e-4):
    """Build a flux-water system from a water-box PDB file — the on-ramp
    for reference users whose workflow starts at ``PDBFile`` + OpenMM
    topology (SURVEY §3.1; the reference itself never parses files, its
    host framework does).

    Waters are recognized by residue (HOH/WAT/SOL/TIP3/TIP/H2O), each
    needing one O and two H; atoms are reordered to the engine's
    (O, H1, H2) molecule template.  Returns (force, positions, masses,
    box, order) where ``positions[order] == pdb order`` maps results back
    to file order, and ``box`` is the PDB's CRYST1 cell ([3] nm or
    triclinic [3, 3]; None for a vacuum cluster).

    Each water's three atoms must be CONTIGUOUS in the file (the normal
    PDB convention): grouping is by (resname, resseq) runs so boxes past
    the resseq-9999 wrap parse correctly, at the cost of rejecting
    exotic files that interleave residues' atoms (the 1-O/2-H per-group
    check below fails loudly on those).
    """
    from ..utils.trajectory import read_pdb

    pdb = read_pdb(path)
    water_res = {"HOH", "WAT", "SOL", "TIP3", "TIP", "H2O"}
    # Group by CONTIGUOUS (resname, resseq) runs, not a global dict key:
    # PDB resseq wraps at 9999 (and chain ids are discarded by the
    # reader), so any box >9999 waters would collide keys under a dict
    # (the 30k bench box is 10648 waters).
    groups = []
    prev = None
    for i, (rn, rs) in enumerate(zip(pdb.resnames, pdb.resseq)):
        if rn.upper() not in water_res:
            raise ValueError(
                f"atom {i}: residue {rn!r} is not a recognized water "
                f"residue ({sorted(water_res)}); this builder handles "
                f"pure water boxes")
        if (rn, rs) != prev:
            groups.append(((rn, rs), []))
            prev = (rn, rs)
        groups[-1][1].append(i)
    perm = []
    for key, idx in groups:
        sym = [pdb.symbols[i].upper() for i in idx]
        o_idx = [i for i, s in zip(idx, sym) if s.startswith("O")]
        h_idx = [i for i, s in zip(idx, sym) if s.startswith("H")]
        if len(o_idx) != 1 or len(h_idx) != 2:
            raise ValueError(
                f"residue {key}: expected 1 O + 2 H in a contiguous "
                f"run, got {sym} (water atoms must be adjacent in the "
                f"file; interleaved-residue PDBs are not supported)")
        perm.extend([o_idx[0], h_idx[0], h_idx[1]])
    perm = np.asarray(perm)
    n_w = len(perm) // 3
    force = CoulForce()
    if pdb.box is not None:
        force.setUsesPeriodicBoundaryConditions(True)
        force.setCutoffDistance(cutoff)
        force.setEwaldErrorTolerance(ewald_tol)
    _build(force, n_w, flux)
    positions = pdb.positions[perm]
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses, pdb.box, perm


def water_box(n_side: int = 6, flux: str = "bond_angle", cutoff: float = 0.9,
              ewald_tol: float = 1e-4, density_spacing: float = 0.3107,
              seed: int = 0):
    """Periodic n_side^3-water box at roughly liquid density.

    Returns (force, positions, masses, box [3]).  n_side=6 gives the
    216-water Ewald box of the benchmark; the default spacing reproduces
    ~997 kg/m^3.
    """
    rng = np.random.default_rng(seed)
    force = CoulForce()
    force.setUsesPeriodicBoundaryConditions(True)
    force.setCutoffDistance(cutoff)
    force.setEwaldErrorTolerance(ewald_tol)
    n_w = n_side ** 3
    _build(force, n_w, flux)
    box = np.full(3, n_side * density_spacing)
    pos = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                center = density_spacing * (np.array([ix, iy, iz]) + 0.5)
                center += 0.01 * rng.standard_normal(3)
                pos.append(_one_water(center, rng))
    positions = np.concatenate(pos, axis=0)
    masses = np.tile(np.array(WATER_MASSES), n_w)
    return force, positions, masses, box
