"""Energy/force parity vs the float64 NumPy oracle.

Test pyramid level 3 (SURVEY §4): the JAX engine must reproduce the
reference-platform semantics at f64 precision — noPBC all-pairs and full
Ewald (self + reciprocal + direct + exclusion) including the dE/dq
chain-rule forces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chargeflux_tpu as cf
from chargeflux_tpu.models import water_box, water_cluster

from helpers import force_to_params
from oracle import energy_forces_nopbc, energy_forces_pbc


@pytest.mark.parametrize("flux", ["bond_angle", "water", "none"])
def test_nopbc_small_cluster(flux):
    force, positions, _ = water_cluster(n_side=2, flux=flux, seed=1)
    system = force.create_system(dtype=jnp.float64)
    x = jnp.asarray(positions)
    e = float(cf.energy(x, system))
    f = np.asarray(cf.forces(x, system))
    e_ref, f_ref = energy_forces_nopbc(positions, force_to_params(force))
    assert abs(e - e_ref) <= 1e-10 * abs(e_ref)
    np.testing.assert_allclose(f, f_ref, rtol=1e-9, atol=1e-9)


def test_nopbc_125_water_cluster():
    """The 125-water cluster: f64 parity with the oracle."""
    force, positions, _ = water_cluster(n_side=5, flux="bond_angle", seed=2)
    system = force.create_system(dtype=jnp.float64)
    x = jnp.asarray(positions)
    e = float(cf.energy(x, system))
    f = np.asarray(cf.forces(x, system))
    e_ref, f_ref = energy_forces_nopbc(positions, force_to_params(force))
    assert abs(e - e_ref) <= 1e-10 * abs(e_ref)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(f / scale, f_ref / scale, atol=1e-11)


@pytest.mark.parametrize("flux", ["bond_angle", "water"])
def test_pbc_ewald_small_box(flux):
    force, positions, _, box = water_box(n_side=3, flux=flux, seed=4)
    system = force.create_system(box=box, dtype=jnp.float64)
    x = jnp.asarray(positions)
    comps = {k: float(v) for k, v in cf.energy_components(x, system).items()}
    e = sum(comps.values())
    f = np.asarray(cf.forces(x, system))
    e_ref, f_ref, comps_ref = energy_forces_pbc(
        positions, force_to_params(force), box,
        force.getCutoffDistance(), force.getEwaldErrorTolerance())
    for key in ("self", "reciprocal", "direct", "exclusion"):
        assert abs(comps[key] - comps_ref[key]) <= 1e-9 * max(abs(comps_ref[key]), 1.0), key
    assert abs(e - e_ref) <= 1e-10 * abs(e_ref)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(f / scale, f_ref / scale, atol=1e-10)


def test_pbc_216_water_box():
    """The 216-water Ewald box: <=1e-10 relative in f64."""
    force, positions, _, box = water_box(n_side=6, flux="bond_angle", seed=6)
    system = force.create_system(box=box, dtype=jnp.float64)
    x = jnp.asarray(positions)
    e = float(cf.energy(x, system))
    f = np.asarray(cf.forces(x, system))
    e_ref, f_ref, _ = energy_forces_pbc(
        positions, force_to_params(force), box,
        force.getCutoffDistance(), force.getEwaldErrorTolerance())
    assert abs(e - e_ref) <= 1e-10 * abs(e_ref)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(f / scale, f_ref / scale, atol=1e-10)


def test_ewald_parameters_match_reference_heuristic():
    """alpha and per-axis kmax (incl. force-odd) follow
    ReferenceCoulKernels.cpp:398-420."""
    from oracle import ewald_alpha_kmax

    for cutoff, tol, box in [(0.9, 1e-4, (1.86, 1.86, 1.86)),
                             (1.0, 1e-4, (3.0, 2.0, 5.0)),
                             (1.2, 1e-5, (4.0, 4.0, 4.0))]:
        a_ref, k_ref = ewald_alpha_kmax(cutoff, tol, np.array(box))
        assert cf.ewald_alpha(cutoff, tol) == pytest.approx(a_ref, rel=1e-15)
        assert list(cf.ewald_kmax(box, a_ref, tol)) == k_ref


def test_energy_only_is_cheap_contract():
    """Energy evaluation never needs the Jacobian path (SURVEY §0.3: dedq
    accumulation only under includeForces) — here: energy() runs without
    computing any gradient, just check it jits standalone."""
    force, positions, _ = water_cluster(n_side=2, seed=8)
    system = force.create_system(dtype=jnp.float64)
    e = jax.jit(cf.energy)(jnp.asarray(positions), system)
    assert np.isfinite(float(e))


def test_erf_over_r_polynomial_accuracy():
    """The exp/divide-free Coulomb kernel P(r^2) ~= erf(alpha r)/r used on
    the f32 direct-space paths: value and analytic-derivative accuracy
    against the exact function over the full [0, cutoff^2] range."""
    import math

    from chargeflux_tpu.ops.erfc import erf_over_r_eval

    alpha, rc = 3.2427, 0.9
    s = np.linspace(1e-4, rc * rc, 5001)
    p, dp = erf_over_r_eval(jnp.asarray(s, jnp.float32), alpha, rc,
                            with_derivative=True)
    f = np.array([math.erf(alpha * math.sqrt(x)) / math.sqrt(x) for x in s])
    fp = (alpha * np.exp(-alpha * alpha * s) / (np.sqrt(np.pi) * s)
          - f / (2 * s))
    assert np.max(np.abs(np.asarray(p, np.float64) - f)) < 1e-6
    # |dP/ds - f'| bound: ~2e-5 nm^-3 == ~1e-7 relative on close-pair forces
    assert np.max(np.abs(np.asarray(dp, np.float64) - fp)) < 1e-4


def test_excluded_pair_beyond_cutoff_cell_vs_dense():
    """SURVEY §5 edge: the net excluded-pair contract is -erf(ar)/r with
    NO erfc/LJ removal when r > cutoff (the walk never counted it).  The
    cell route's conditional subtraction must agree with the dense route
    on a deliberately long-range exclusion (the reference CPU path applies
    its correction unconditionally but erfc(ar) ~ 0 there; the routes
    coincide in exact arithmetic)."""
    force, positions, _, box = water_box(n_side=10, flux="bond_angle",
                                         seed=9)
    # cross-molecule exclusion between two far-apart oxygens (> cutoff)
    o_a, o_b = 0, 3 * 500
    r = np.linalg.norm(positions[o_a] - positions[o_b])
    assert r > force.getCutoffDistance()
    force.addException(o_a, o_b)
    x = jnp.asarray(positions)
    es = {}
    for method in ("cell", "dense"):
        system = force.create_system(box=box, dtype=jnp.float64,
                                     direct_method=method)
        es[method] = float(cf.energy(x, system))
    assert abs(es["cell"] - es["dense"]) <= 1e-10 * abs(es["dense"])
