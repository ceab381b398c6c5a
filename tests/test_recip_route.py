"""The reciprocal route resolver (energy.resolve_recip_method): one rule,
independent of the backend, shared by the single-device engine and the
halo route, with the PME patch-slack guard wherever PME is resolved."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from chargeflux_tpu.energy import (_energy, _energy_and_forces,
                                   resolve_recip_method)
from chargeflux_tpu.models import water_box


def _spec(direct, recip="auto"):
    force, _, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                 seed=44)
    return force.create_system(box=box, dtype=jnp.float32,
                               direct_method=direct,
                               recip_method=recip).spec


@pytest.mark.parametrize("direct,dtype,route", [
    ("cell", jnp.float32, "pme"),
    ("dense", jnp.float32, "xla"),
    ("cell", jnp.float64, "xla"),
    ("dense", jnp.float64, "xla"),
])
def test_auto_route_rule(direct, dtype, route):
    assert resolve_recip_method(_spec(direct), dtype) == route


@pytest.mark.parametrize("recip", ["xla", "pme"])
def test_explicit_route_stands(recip):
    for direct in ("cell", "dense"):
        for dtype in (jnp.float32, jnp.float64):
            assert resolve_recip_method(_spec(direct, recip), dtype) == recip


def test_auto_route_matches_explicit_pme_on_cell_f32():
    """f32 "auto" on the cell route evaluates the same program as an
    explicit "pme": identical energy and forces."""
    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=13)
    x = jnp.asarray(pos, jnp.float32)
    auto = force.create_system(box=box, dtype=jnp.float32,
                               direct_method="cell")
    pme = dataclasses.replace(
        auto, spec=dataclasses.replace(auto.spec, recip_method="pme"))
    e_a, f_a = _energy_and_forces(x, auto)
    e_p, f_p = _energy_and_forces(x, pme)
    assert float(e_a) == float(e_p)
    np.testing.assert_array_equal(np.asarray(f_a), np.asarray(f_p))


def test_halo_and_single_device_resolve_alike():
    """The halo route asks the same resolver: under f32 "auto" it takes the
    distributed SPME, agreeing with the single-device PME on one mesh to
    f32 summation order — closer than the classical route comes."""
    from chargeflux_tpu.parallel import halo
    from chargeflux_tpu.pme import pme_halo_mesh

    assert halo.resolve_recip_method is resolve_recip_method
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=44)
    sys0 = force.create_system(box=box, dtype=jnp.float32,
                               direct_method="cell")
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell",
                                 pme_grid=pme_halo_mesh(sys0.spec))
    x = jnp.asarray(pos, jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("space",))
    _, f_ref = _energy_and_forces(x, system)
    rms = float(np.sqrt(np.mean(np.asarray(f_ref, np.float64) ** 2)))

    def rel_force_err(sys_h):
        f = -jax.grad(halo.make_halo_energy_fn(sys_h, mesh))(x)
        d = np.asarray(f, np.float64) - np.asarray(f_ref, np.float64)
        return float(np.sqrt(np.mean(d ** 2))) / rms

    xla = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, recip_method="xla"))
    err_auto, err_xla = rel_force_err(system), rel_force_err(xla)
    assert err_auto < 1e-5, err_auto
    assert err_auto < 0.1 * err_xla, (err_auto, err_xla)


def test_slack_guard_fires_under_auto_f32():
    """With f32 "auto" resolving to PME on the cell route, the patch-slack
    guard is on: under a grown box, drift past the static slack budget
    NaN-poisons energy and forces; drift below it stays finite."""
    from chargeflux_tpu.neighbors import build_neighbor_state, skin_radius

    force, pos, _, box = water_box(n_side=8, cutoff=0.55)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell")
    spec = system.spec
    assert spec.recip_method == "auto"
    assert resolve_recip_method(spec, jnp.float32) == "pme"
    s = 1.3
    sys_big = system.with_box(s * jnp.asarray(box, jnp.float32))
    x_big = s * jnp.asarray(pos, jnp.float32)
    nb = build_neighbor_state(x_big, sys_big)

    h = s * np.asarray(box) / np.asarray(spec.pme_grid)
    budget = float(np.min(np.asarray(spec.pme_slack) * h))
    skin_now = float(skin_radius(sys_big))
    assert 0.5 * skin_now > budget

    x_ok = x_big.at[0, 0].add(0.8 * budget)
    assert np.isfinite(float(_energy(x_ok, sys_big, nb=nb)))
    x_bad = x_big.at[0, 0].add(min(1.2 * budget, 0.49 * skin_now))
    assert np.isnan(float(_energy(x_bad, sys_big, nb=nb)))
    g = jax.grad(lambda xx: _energy(xx, sys_big, nb=nb))(x_bad)
    assert np.isnan(np.asarray(g)).all()
