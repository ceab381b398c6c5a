"""End-to-end oracle parity for a heterogeneous (mixed-species) system.

The reference API is species-agnostic (CoulForce.cpp:18-125: arbitrary
particles, exclusions and flux terms); the water-box tests all hit the
molecule-template fast paths, so this box mixes flexible waters with ions
(no flux, no exclusions) — topology detection must decline and the general
gather/scatter paths must still match the NumPy f64 oracle on the cell
route, with forces equal to the analytic-chain-rule path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import helpers
import oracle
from chargeflux_tpu import energy_and_forces, forces_manual
from chargeflux_tpu.models import water_box
from chargeflux_tpu.models.water import EPS_O, SIG_O


@pytest.fixture(scope="module", params=["uniform", "ragged"])
def salty_box(request):
    """7^3-molecule water box with 40 waters replaced by ions.

    "uniform": every water carries the same 3 exclusions — topology must
    detect the template *with an offset* past the ion block.  "ragged":
    one water drops its H-H exclusion, so detection must decline and the
    general gather/scatter paths run end-to-end.
    """
    ragged = request.param == "ragged"
    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=11)
    # rebuild: first 40 molecules' H atoms dropped, O turned into an ion
    params = helpers.force_to_params(force)
    n_mol = len(pos) // 3
    keep_water = range(40, n_mol)
    xs = []
    from chargeflux_tpu.system import CoulForce
    f2 = CoulForce()
    f2.setCutoffDistance(0.65)
    f2.setUsesPeriodicBoundaryConditions(True)
    idx = {}
    for m in range(40):
        sign = 1.0 if m % 2 == 0 else -1.0
        idx[(m, 0)] = f2.addParticle(sign * 1.0, SIG_O, EPS_O)
        xs.append(pos[3 * m])
    for m in keep_water:
        for a in range(3):
            q, s, e = params["q0"][3 * m + a], params["sigma"][3 * m + a], \
                params["epsilon"][3 * m + a]
            idx[(m, a)] = f2.addParticle(float(q), float(s), float(e))
            xs.append(pos[3 * m + a])
    for j, m in enumerate(keep_water):
        o, h1, h2 = idx[(m, 0)], idx[(m, 1)], idx[(m, 2)]
        f2.addException(o, h1)
        f2.addException(o, h2)
        if not (ragged and j == 5):
            f2.addException(h1, h2)
        from chargeflux_tpu.models.water import (ANGLE_HOH, K_ANGLE, K_BOND,
                                                 R_OH)
        f2.addFluxBond(o, h1, K_BOND, R_OH)
        f2.addFluxBond(o, h2, K_BOND, R_OH)
        f2.addFluxAngle(h1, o, h2, K_ANGLE, ANGLE_HOH)
    return f2, np.asarray(xs), np.asarray(box), ragged


def test_heterogeneous_oracle_parity_cell(salty_box):
    force, pos, box, ragged = salty_box
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    ts = system.spec.excl_template
    if ragged:
        # one water drops its H-H exclusion: the run SPLITS around it —
        # two templates plus the odd molecule's rows as scatter remainder
        # (multi-template detection)
        assert ts is not None and len(ts.templates) == 2
        assert sum(c for _, c in ts.remainder) == 2
    else:
        assert ts is not None and len(ts.templates) == 1
        assert ts.templates[0].offset == 40   # ion-prefix template
    e, f = energy_and_forces(jnp.asarray(pos, jnp.float64), system)
    eo, fo, _ = oracle.energy_forces_pbc(pos, helpers.force_to_params(force),
                                         box, 0.65, 1e-4)
    assert abs(float(e) - eo) / abs(eo) < 1e-10
    assert np.max(np.abs(np.asarray(f) - fo)) < 1e-9


def test_heterogeneous_manual_matches_autodiff(salty_box):
    force, pos, box, _ragged = salty_box
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    x = jnp.asarray(pos, jnp.float64)
    _, f_auto = energy_and_forces(x, system)
    f_man = forces_manual(x, system)
    assert np.max(np.abs(np.asarray(f_auto) - np.asarray(f_man))) < 1e-9


# ---------------------------------------------------------------------------
# Solvated chain solute (multi-template: template + scatter remainder)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_box():
    from chargeflux_tpu.models import solvated_chain_box
    return solvated_chain_box(n_side=6, n_solute_sites=5, cutoff=0.58,
                              seed=7)


def test_solvated_chain_template_structure(chain_box):
    """The chain (one 15-bead component, span > stride limit) must land on
    the scatter remainder; the waters must still template at an offset."""
    force, pos, masses, box, bonded_kw = chain_box
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    n_chain = 15
    fts = system.spec.flux_template
    assert fts is not None and len(fts.templates) == 1
    tpl = fts.templates[0]
    assert tpl.offset == n_chain and tpl.stride == 3
    assert tpl.count == 6 ** 3 - 5
    rem = dict(fts.remainder)
    assert rem["bonds"] == n_chain - 1         # the chain's flux bonds
    assert rem["angles"] == 0 and rem["waters"] == 0
    ets = system.spec.excl_template
    assert dict(ets.remainder)["exclusions"] == 2 * n_chain - 3


def test_solvated_chain_oracle_parity(chain_box):
    force, pos, masses, box, bonded_kw = chain_box
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    x = jnp.asarray(pos, jnp.float64)
    e, f = energy_and_forces(x, system)
    eo, fo, _ = oracle.energy_forces_pbc(pos, helpers.force_to_params(force),
                                         box, 0.58, 1e-4)
    assert abs(float(e) - eo) / abs(eo) < 1e-10
    # 5e-9 absolute (~1e-14 relative to the chain's bonded-force scale):
    # the cell route's compute-then-subtract exclusion contract leaves
    # slightly more cancellation roundoff than the oracle's filtered sum
    assert np.max(np.abs(np.asarray(f) - fo)) < 5e-9
    f_man = forces_manual(x, system)
    assert np.max(np.abs(np.asarray(f_man) - fo)) < 5e-9


def test_solvated_chain_md_stable(chain_box):
    """Short f64 NVE through the full heterogeneous stack — flux charges,
    exclusions AND bonded terms all split template + remainder."""
    from chargeflux_tpu.bonded import BondedParams
    from chargeflux_tpu.integrate import (init_state_nb, make_nb_energy_fn,
                                          nve_trajectory_nb)
    force, pos, masses, box, bonded_kw = chain_box
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    bonded = BondedParams.create(box=box, pbc=True, dtype=jnp.float64,
                                 **bonded_kw)
    # bonded remainder split mirrors the flux one: chain rows at the tail
    assert bonded.template is not None
    assert len(bonded.template.templates) == 1
    e_fn, init_nb = make_nb_energy_fn(system, bonded=bonded)
    x = jnp.asarray(pos, jnp.float64)
    s0 = init_state_nb(x, jnp.zeros_like(x), e_fn, init_nb)
    _s1, es = nve_trajectory_nb(
        s0, e_fn, init_nb, jnp.asarray(np.asarray(masses)), 2e-5, 40,
        rebuild_every=10)
    es = np.asarray(es)
    assert np.all(np.isfinite(es))
    assert np.max(np.abs(es - es[0])) < 1.0   # kJ/mol over 40 tiny steps
