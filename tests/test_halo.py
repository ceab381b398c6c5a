"""Spatial slab decomposition with ppermute halo exchange (parallel/halo.py).

Equality of the sharded program against the single-device engine on the
8-virtual-device CPU mesh, for energy AND forces (the halo force exchange is
the AD transpose of the ppermute), including a ~100k-atom box.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from chargeflux_tpu.energy import _energy, _energy_and_forces
from chargeflux_tpu.models import water_box
from chargeflux_tpu.parallel import make_sharded_energy_fn
from chargeflux_tpu.parallel.halo import halo_compatible, make_halo_energy_fn


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _small_system():
    # box 2.4856 nm, cutoff 0.31 -> cell grid 8^3 (divisible by 1,2,4,8)
    force, pos, _, box = water_box(n_side=8, flux="bond_angle", cutoff=0.29,
                                   seed=44)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    assert system.spec.cell_grid == (8, 8, 8)
    return system, jnp.asarray(pos)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_energy_matches_single_device(ndev):
    system, x = _small_system()
    assert halo_compatible(system, ndev)
    e_ref = float(_energy(x, system))
    e_fn = make_halo_energy_fn(system, _mesh(ndev))
    e = float(e_fn(x))
    np.testing.assert_allclose(e, e_ref, rtol=1e-12)


def test_halo_forces_match_single_device():
    system, x = _small_system()
    _, f_ref = _energy_and_forces(x, system)
    e_fn = make_halo_energy_fn(system, _mesh(8))
    f = -jax.grad(e_fn)(x)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("decomp", [(4, 2), (2, 4), (2, 2), (1, 4)])
def test_halo_2d_decomposition_matches_single_device(decomp):
    """The 2-D x-by-y brick decomposition (two-stage halo exchange; the
    scale-out past gx devices) must match the single-device
    engine for energy AND forces, on both recip routes."""
    system, x = _small_system()
    ndev = decomp[0] * decomp[1]
    e_ref, f_ref = _energy_and_forces(x, system)
    e_fn = make_halo_energy_fn(system, _mesh(ndev), decomp=decomp)
    np.testing.assert_allclose(float(e_fn(x)), float(e_ref), rtol=1e-11)
    f = -jax.grad(e_fn)(x)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               rtol=1e-9, atol=1e-11)


def test_halo_2d_distributed_pme_matches_single_device():
    """2-D decomposition with the distributed SPME spread: y gets the
    same dynamic-offset local fold as x (pme_halo_mesh pad_y) and must
    match single-chip PME on the same (padded) mesh to rounding."""
    from chargeflux_tpu.pme import pme_halo_mesh

    system, x = _small_system()
    mesh_grid = pme_halo_mesh(system.spec, pad_y=True)
    sys_pme = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, recip_method="pme",
                                         pme_grid=mesh_grid))
    e_ref, f_ref = _energy_and_forces(x, sys_pme)
    e_fn = make_halo_energy_fn(sys_pme, _mesh(8), decomp=(4, 2))
    np.testing.assert_allclose(float(e_fn(x)), float(e_ref), rtol=1e-11)
    f = -jax.grad(e_fn)(x)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               rtol=1e-9, atol=1e-11)


def test_halo_decomp_selection():
    """halo_decomp prefers pure x-slabs (one ppermute), falls to 2-D when
    gx doesn't divide or ndev exceeds gx, and returns None only when no
    factorization fits."""
    from chargeflux_tpu.parallel.halo import halo_decomp

    system, _x = _small_system()          # grid (8, 8, 8)
    assert halo_decomp(system, 8) == (8, 1)
    assert halo_decomp(system, 4) == (4, 1)
    # more devices than gx: the 2-D form scales on
    assert halo_decomp(system, 16) == (8, 2)
    assert halo_decomp(system, 64) == (8, 8)
    assert halo_decomp(system, 7) is None   # 7 divides neither axis
    g5 = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, cell_grid=(5, 8, 8)))
    assert halo_decomp(g5, 4) == (1, 4)     # gx=5 indivisible -> y slabs


def test_sharded_constructor_selects_halo():
    system, x = _small_system()
    e_fn = make_sharded_energy_fn(system, _mesh(8))
    np.testing.assert_allclose(float(e_fn(x)), float(_energy(x, system)),
                               rtol=1e-12)


def test_halo_overflow_poisons():
    system, x = _small_system()
    tiny = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, cell_capacity=2))
    e_fn = make_halo_energy_fn(tiny, _mesh(4))
    assert np.isnan(float(e_fn(x)))


def test_halo_100k_cell_path_equality():
    """100k-atom cell-path equality on the 8-device CPU
    mesh (kmax shrunk — the reciprocal term is index-chunked and orthogonal
    to the halo direct space under test).  f64: this short-cutoff config has
    ~2.8e7-magnitude self/direct/exclusion components cancelling to ~4e5, so
    f32 summation-order noise would swamp a logic comparison."""
    force, pos, _, box = water_box(n_side=32, flux="bond_angle", cutoff=0.59,
                                   seed=45)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    system = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, kmax=(3, 3, 3),
                                         recip_method="xla"))
    assert system.spec.cell_grid[0] % 8 == 0
    x = jnp.asarray(pos)
    e_ref = float(_energy(x, system))
    e_fn = make_halo_energy_fn(system, _mesh(8))
    e = float(e_fn(x))
    np.testing.assert_allclose(e, e_ref, rtol=1e-10)


def test_halo_collective_structure():
    """The compiled halo program must communicate by boundary-plane
    ppermutes + psum assembly ONLY: any all-gather/all-to-all means the
    sharding silently degraded to replication (the pathology the
    halo design replaces).  Counts from the 4-device compile: 3
    collective-permutes (x-boundary planes + force transpose), 4
    all-reduces (energy/S(k)/force psums) — pinned with slack."""
    import re

    force, pos, _, box = water_box(n_side=4, flux="bond_angle", cutoff=0.147)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    mesh = _mesh(4)
    assert halo_compatible(system, 4)
    fn = make_sharded_energy_fn(system, mesh, axis_name="space")
    x = jnp.asarray(pos)
    txt = jax.jit(jax.value_and_grad(fn)).lower(x).compile().as_text()

    def count(op):
        return len(re.findall(rf"{op}\(", txt)) + \
            len(re.findall(rf"{op}-start\(", txt))

    assert 1 <= count("collective-permute") <= 6
    assert 1 <= count("all-reduce") <= 8
    assert count("all-gather") == 0
    assert count("all-to-all") == 0


@pytest.mark.parametrize("ndev", [2, 8])
def test_halo_pme_recip_matches_single_device(ndev):
    """Distributed SPME on the halo route (per-device slab spread + one
    psum of the charge mesh) must match the single-chip cell-blocked PME
    on the same mesh to reduction-order rounding, energy AND forces."""
    from chargeflux_tpu.pme import pme_halo_mesh

    system, x = _small_system()
    mesh_grid = pme_halo_mesh(system.spec)
    sys_pme = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, recip_method="pme",
                                         pme_grid=mesh_grid))
    e_ref, f_ref = _energy_and_forces(x, sys_pme)
    e_fn = make_halo_energy_fn(sys_pme, _mesh(ndev))
    np.testing.assert_allclose(float(e_fn(x)), float(e_ref), rtol=1e-12)
    f = -jax.grad(e_fn)(x)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                               rtol=1e-9, atol=1e-11)


def test_halo_md_trajectory_matches_single_chip():
    """End-to-end multichip MD: nve_trajectory driven by the halo-sharded
    energy (spatial decomposition + ppermute + distributed recip) must
    reproduce the single-chip trajectory — the sharded engine is a drop-in
    energy_fn for every integrator."""
    from chargeflux_tpu.integrate import init_state, nve_trajectory

    system, x = _small_system()
    masses = jnp.ones(x.shape[0], jnp.float64) * 10.0
    dt = 2e-5

    e_halo = make_halo_energy_fn(system, _mesh(4))
    e_ref = lambda xx: _energy(xx, system)

    etots = {}
    finals = {}
    for name, fn in (("halo", e_halo), ("single", e_ref)):
        s0 = init_state(x, jnp.zeros_like(x), fn)
        finals[name], etots[name] = nve_trajectory(s0, fn, masses, dt, 5)
    np.testing.assert_allclose(np.asarray(etots["halo"]),
                               np.asarray(etots["single"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(finals["halo"].positions),
                               np.asarray(finals["single"].positions),
                               rtol=1e-10, atol=1e-12)


def test_halo_devices_grid_rounding():
    """create_system(halo_devices=D) rounds the x cell axis down to a
    multiple of D (wider cells keep cutoff coverage), unlocking the
    ppermute halo path for boxes whose natural grid doesn't divide the
    mesh; energies match the natural-grid system and the sharded route
    matches single-chip."""
    import chargeflux_tpu as cf
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.parallel.halo import (halo_compatible,
                                              make_halo_energy_fn)

    force, pos, _, box = water_box(n_side=8, flux="water", cutoff=0.42,
                                   seed=3)
    x = jnp.asarray(pos)
    s_nat = force.create_system(box=box, dtype=jnp.float64,
                                direct_method="cell")
    assert s_nat.spec.cell_grid[0] % 4 != 0          # the case that matters
    assert not halo_compatible(s_nat, 4)
    s_halo = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", halo_devices=4)
    assert s_halo.spec.cell_grid[0] % 4 == 0
    assert halo_compatible(s_halo, 4)
    e_ref = float(cf.energy(x, s_nat))
    assert abs(float(cf.energy(x, s_halo)) - e_ref) <= 1e-12 * abs(e_ref)
    mesh = Mesh(np.array(jax.devices()[:4]), ("space",))
    e_h = float(make_halo_energy_fn(s_halo, mesh)(x))
    assert abs(e_h - e_ref) <= 1e-12 * abs(e_ref)
    # a device count past gx lands on the 2-D x-by-y sizing
    from chargeflux_tpu.parallel.halo import halo_decomp
    s_2d = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", halo_devices=8)
    assert halo_decomp(s_2d, 8) is not None
    assert halo_decomp(s_2d, 8)[1] > 1
    e_2d = float(cf.energy(x, s_2d))
    assert abs(e_2d - e_ref) <= 1e-12 * abs(e_ref)
    mesh8 = Mesh(np.array(jax.devices()[:8]), ("space",))
    e_h8 = float(make_halo_energy_fn(s_2d, mesh8)(x))
    assert abs(e_h8 - e_ref) <= 1e-12 * abs(e_ref)
    # genuinely impossible sizing still refuses loudly
    with pytest.raises(ValueError, match="halo_devices"):
        force.create_system(box=box, dtype=jnp.float64,
                            direct_method="cell", halo_devices=64)


def test_halo_devices_forces_cell_route():
    """An explicit halo_devices request must never be silently dropped:
    auto resolves to the cell route even below the auto-threshold atom
    count, and an explicit dense request conflicts loudly."""
    force, pos, _, box = water_box(n_side=6, flux="water", cutoff=0.42,
                                   seed=3)   # 648 atoms < auto threshold
    s = force.create_system(box=box, dtype=jnp.float64, halo_devices=2)
    assert s.spec.direct_method == "cell"
    assert s.spec.cell_grid[0] % 2 == 0
    with pytest.raises(ValueError, match="halo_devices"):
        force.create_system(box=box, dtype=jnp.float64,
                            direct_method="dense", halo_devices=2)


def test_halo_traced_box_moves_and_guards():
    """NPT x halo: the halo energy takes a (traced) box arg —
    a small volume move matches the single-chip with_box energy/forces
    exactly; a shrink past grid validity NaN-poisons in-jit (the
    energy.py guard pattern); an *invalid creation box* still refuses at
    build time (config error, not a runtime move)."""
    from chargeflux_tpu.parallel.halo import make_halo_energy_fn
    force, pos, _, box = water_box(n_side=10, flux="bond_angle",
                                   cutoff=0.6, seed=2)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", halo_devices=2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    e_fn = make_halo_energy_fn(system, mesh)
    x = jnp.asarray(pos)
    for s in (1.02, 0.985):
        box_s = s * jnp.asarray(box)
        x_s = s * x        # scale coordinates with the box (physical move)
        e_ref, f_ref = _energy_and_forces(x_s, system.with_box(box_s))
        np.testing.assert_allclose(float(e_fn(x_s, box_s)), float(e_ref),
                                   rtol=1e-11)
        f = -jax.grad(e_fn)(x_s, box_s)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref),
                                   rtol=1e-8, atol=1e-10)
    # grid-validity shrink: poisoned, never silently missing pairs
    assert np.isnan(float(e_fn(x * 0.7, 0.7 * jnp.asarray(box))))
    # invalid CREATION box still refuses at build
    shrunk = system.with_box(0.7 * jnp.asarray(box))
    with pytest.raises(ValueError, match="creation-time"):
        make_halo_energy_fn(shrunk, mesh)


def test_npt_over_halo_matches_single_chip():
    """npt_langevin_trajectory(energy_fn=halo) on the virtual mesh must
    reproduce the single-chip NPT trajectory (same key): the barostat's
    volume moves ride the halo energy's traced box, and the composition
    is exact because the halo route re-bins fresh every step."""
    from chargeflux_tpu.npt import npt_langevin_trajectory
    from chargeflux_tpu.parallel.halo import make_halo_energy_fn

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.42, seed=7)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", halo_devices=2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    e_halo = make_halo_energy_fn(system, mesh)
    x = jnp.asarray(pos)
    m = jnp.asarray(np.asarray(masses))
    key = jax.random.PRNGKey(11)
    kw = dict(dt=5e-4, temperature=250.0, friction=2.0, pressure_bar=1.0,
              key=key, n_steps=4, barostat_interval=2)
    x_h, v_h, box_h, diag_h = npt_langevin_trajectory(
        x, jnp.zeros_like(x), system, m, energy_fn=e_halo, **kw)
    x_s, v_s, box_s, diag_s = npt_langevin_trajectory(
        x, jnp.zeros_like(x), system, m, **kw)
    assert np.all(np.isfinite(np.asarray(diag_h["energies"])))
    np.testing.assert_allclose(np.asarray(box_h), np.asarray(box_s),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(x_h), np.asarray(x_s),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(diag_h["energies"]),
                               np.asarray(diag_s["energies"]), rtol=1e-8)


@pytest.mark.slow
def test_halo_slab_binning_scales_to_1m_atoms():
    """A flat [N, n_local] one-hot would wall the halo path at ~1M
    atoms; the shared two-stage ranking must bin a 1M-atom slab with
    bounded intermediates (largest: [N, gxl*gy] = 128M int32) and account
    for every owned atom.  CPU shape-scale proof."""
    from chargeflux_tpu.parallel.halo import _local_bin

    n, ndev = 1_000_000, 8
    grid, cap = (32, 32, 32), 256
    gxl = grid[0] // ndev
    rng = np.random.default_rng(0)
    box = np.array([10.0, 10.0, 10.0])
    pos = jnp.asarray(rng.uniform(0, 10.0, (n, 3)), jnp.float32)

    box_j = jnp.asarray(box, jnp.float32)

    class _Spec:
        cell_grid, cell_capacity = (32, 32, 32), 256

    class _Sys:
        spec = _Spec()
        box = box_j

    slots, slot_of, overflow = jax.jit(
        _local_bin, static_argnums=(1, 2, 3, 4, 5))(pos, _Sys(), 0, 0,
                                                    gxl, grid[1])
    assert slots.shape == (gxl * grid[1] * grid[2], cap)
    frac = np.asarray(pos) / 10.0
    owned = (frac[:, 0] * grid[0]).astype(int) < gxl
    n_binned = int(np.sum(np.asarray(slots) < n))
    assert n_binned + int(overflow) == int(np.sum(owned))
    assert int(overflow) == 0         # cap 256 >> mean occupancy ~244/8
    # inv consistency on a sample
    sof = np.asarray(slot_of)
    flat = np.asarray(slots).ravel()
    sample = np.where(owned)[0][:1000]
    assert np.all(flat[sof[sample]] == sample)


def test_aniso_npt_over_halo_triclinic():
    """The anisotropic barostat composes with the halo energy on a
    triclinic lattice: per-row scaling rides the traced [3, 3] box
    through the halo route and the trajectory stays finite with the
    reduced lower-triangular form preserved."""
    from chargeflux_tpu.npt import npt_anisotropic_langevin_trajectory
    from chargeflux_tpu.parallel.halo import make_halo_energy_fn

    force, pos, masses, box = water_box(n_side=6, flux="bond_angle",
                                        cutoff=0.42, seed=7)
    L = np.asarray(box, np.float64)
    B = np.array([[L[0], 0.0, 0.0],
                  [0.10 * L[0], L[1], 0.0],
                  [0.05 * L[0], -0.08 * L[1], L[2]]])
    system = force.create_system(box=B, dtype=jnp.float64,
                                 direct_method="cell", halo_devices=2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    e_halo = make_halo_energy_fn(system, mesh)
    x = jnp.asarray(pos)
    m = jnp.asarray(np.asarray(masses))
    x1, v1, b1, diag = npt_anisotropic_langevin_trajectory(
        x, jnp.zeros_like(x), system, m, dt=2e-4, temperature=250.0,
        friction=5.0, pressure_bar=1.0, key=jax.random.PRNGKey(5),
        n_steps=4, barostat_interval=2, energy_fn=e_halo)
    assert np.all(np.isfinite(np.asarray(diag["energies"])))
    b1 = np.asarray(b1)
    assert b1[0, 1] == 0.0 and b1[0, 2] == 0.0 and b1[1, 2] == 0.0
    for a in range(3):
        s = b1[a, a] / B[a, a]
        np.testing.assert_allclose(b1[a], s * B[a], rtol=1e-12, atol=1e-15)
