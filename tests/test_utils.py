"""Checkpoint round-trip and scene-spec serialization tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chargeflux_tpu as cf
from chargeflux_tpu.integrate import init_state, make_energy_fn
from chargeflux_tpu.models import water_cluster
from chargeflux_tpu.utils import load_checkpoint, save_checkpoint


def test_checkpoint_roundtrip(tmp_path):
    force, pos, _ = water_cluster(n_side=2, seed=71)
    system = force.create_system(dtype=jnp.float64)
    e_fn = make_energy_fn(system)
    state = init_state(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)), e_fn)
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, state, step=42, extra={"note": "test"})
    restored, step = load_checkpoint(path, state)
    assert step == 42
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_coulforce_dict_roundtrip():
    force, pos, _ = water_cluster(n_side=2, flux="water", seed=72)
    force.setCutoffDistance(0.75)
    force.setEwaldErrorTolerance(3e-5)
    d = force.to_dict()
    force2 = cf.CoulForce.from_dict(d)
    assert force2.getNumParticles() == force.getNumParticles()
    assert force2.getNumExceptions() == force.getNumExceptions()
    assert force2.getNumFluxWaters() == force.getNumFluxWaters()
    assert force2.getCutoffDistance() == force.getCutoffDistance()
    assert force2.getEwaldErrorTolerance() == force.getEwaldErrorTolerance()
    s1 = force.create_system(dtype=jnp.float64)
    s2 = force2.create_system(dtype=jnp.float64)
    x = jnp.asarray(pos)
    assert float(cf.energy(x, s1)) == pytest.approx(float(cf.energy(x, s2)),
                                                    rel=1e-14)


def test_load_checkpoint_rejects_mismatched_template(tmp_path):
    """Structural validation: same leaf count, different shapes
    or treedef must raise, not silently transpose arrays."""
    import pytest

    from chargeflux_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    state = {"a": jnp.zeros((4, 3)), "b": jnp.ones((7,))}
    path = str(tmp_path / "ck")
    save_checkpoint(path, state, step=3)

    wrong_shape = {"a": jnp.zeros((3, 4)), "b": jnp.ones((7,))}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, wrong_shape)

    wrong_tree = {"x": jnp.zeros((4, 3)), "y": jnp.ones((7,))}
    with pytest.raises(ValueError, match="treedef"):
        load_checkpoint(path, wrong_tree)

    back, step = load_checkpoint(path, state)
    assert step == 3 and back["a"].shape == (4, 3)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory and the
    helper sets no other."""
    from chargeflux_tpu.utils import compile_cache

    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache(3.0) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 3.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


def test_compile_cache_dir_default_is_fixed(monkeypatch):
    """Without the variable the cache sits at the fixed <checkout>/.jax_cache
    (the key includes the path, so it must not move between runs)."""
    import os

    from chargeflux_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert path == compile_cache.compile_cache_dir()


def test_pallas_recip_rejects_f64():
    """recip_method='pallas' (the removed fused structure-factor kernel)
    is rejected at build time with a message that names the routes left."""
    import pytest

    from chargeflux_tpu.models import water_box

    force, _, _, box = water_box(n_side=4, flux="bond_angle", cutoff=0.62,
                                 density_spacing=0.62)
    for dtype in (jnp.float32, jnp.float64):
        with pytest.raises(ValueError, match="'pallas' was removed.*'xla'"):
            force.create_system(box=box, dtype=dtype, recip_method="pallas")


def test_create_system_rejects_unknown_methods():
    """Unknown direct/recip methods must fail loudly at build time — the
    removed 'cell_pallas' used to fall through to the dense O(N^2) path
    silently and crash the sharded builder later."""
    import pytest

    from chargeflux_tpu.models import water_box

    force, _, _, box = water_box(n_side=4, flux="bond_angle", cutoff=0.62,
                                 density_spacing=0.62)
    with pytest.raises(ValueError, match="direct_method"):
        force.create_system(box=box, direct_method="cell_pallas")
    with pytest.raises(ValueError, match="recip_method"):
        force.create_system(box=box, recip_method="bogus")


def test_xyz_round_trip(tmp_path):
    """write_xyz -> read_xyz round-trips frames, symbols and comments;
    water masses resolve to O/H and coordinates convert nm <-> Angstrom."""
    from chargeflux_tpu.utils import read_xyz, symbols_from_masses, write_xyz
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 2, (3, 6, 3))
    masses = [15.999, 1.008, 1.008, 15.999, 1.008, 1.008]
    path = str(tmp_path / "traj.xyz")
    n = write_xyz(path, frames, masses=masses)
    assert n == 3
    back, syms, comments = read_xyz(path)
    np.testing.assert_allclose(back, frames, atol=1e-6)
    assert syms == ["O", "H", "H", "O", "H", "H"]
    assert comments == ["frame 0", "frame 1", "frame 2"]
    # append mode adds frames
    write_xyz(path, frames[0], masses=masses, append=True,
              comments=["tail"])
    back2, _, c2 = read_xyz(path)
    assert back2.shape == (4, 6, 3) and c2[-1] == "tail"
    assert symbols_from_masses([22.99, 35.45, 77.7]) == ["Na", "Cl", "X"]


def test_rdf_uniform_gas_is_flat():
    """g(r) = 1 for uniformly random points (both same-selection and
    disjoint selections), up to counting noise."""
    from chargeflux_tpu.utils import radial_distribution
    rng = np.random.default_rng(1)
    box = np.array([4.0, 4.0, 4.0])
    x = jnp.asarray(rng.uniform(0, 4, (2000, 3)))
    idx = np.arange(2000)
    r, g = radial_distribution(x, box, idx, idx, r_max=1.9, n_bins=20)
    g = np.asarray(g)
    assert r.shape == (20,) and g.shape == (20,)
    # skip the first bins (few ideal pairs -> noisy); the rest sit at 1
    assert np.all(np.abs(g[4:] - 1.0) < 0.1), g
    # disjoint selections normalize without the self-pair correction
    r2, g2 = radial_distribution(x, box, idx[:1000], idx[1000:],
                                 r_max=1.9, n_bins=20)
    assert np.all(np.abs(np.asarray(g2)[4:] - 1.0) < 0.15), g2


def test_rdf_water_oo_peak():
    """g_OO of the (lattice-jittered) water box peaks near the lattice
    spacing and is ~0 inside the excluded core."""
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.utils import radial_distribution
    _, pos, _, box = water_box(n_side=6, seed=2)
    o_idx = np.arange(0, len(pos), 3)
    r, g = radial_distribution(jnp.asarray(pos), box, o_idx, o_idx,
                               r_max=0.9, n_bins=45)
    g = np.asarray(g)
    assert g[np.asarray(r) < 0.2].max() < 1e-9      # excluded core
    peak_r = float(np.asarray(r)[np.argmax(g)])
    assert 0.25 < peak_r < 0.4 and g.max() > 2.0


def test_msd_ballistic_and_diffusive():
    from chargeflux_tpu.utils.analysis import mean_squared_displacement
    # ballistic: x = v t -> MSD = |v|^2 lag^2
    t = np.arange(20)[:, None, None]
    v = np.array([[0.1, 0.2, -0.05]])[None]
    frames = t * v
    msd = mean_squared_displacement(frames, max_lag=5)
    v2 = float(np.sum(v * v))
    np.testing.assert_allclose(msd, v2 * (np.arange(1, 6) ** 2), rtol=1e-12)
    # random walk: MSD ~ linear in lag (ratio test, loose)
    rng = np.random.default_rng(0)
    walk = np.cumsum(rng.standard_normal((2000, 50, 3)), axis=0)
    msd_w = mean_squared_displacement(walk, max_lag=20)
    ratio = msd_w[19] / msd_w[4]
    assert 3.0 < ratio < 5.0   # ~20/5 = 4


def test_vacf_constant_and_noise():
    from chargeflux_tpu.utils.analysis import velocity_autocorrelation
    # constant velocities: perfectly correlated at every lag
    v = np.tile(np.array([[0.3, -0.1, 0.2]]), (30, 5, 1))
    c = velocity_autocorrelation(v, max_lag=10)
    np.testing.assert_allclose(c, 1.0, atol=1e-12)
    # white noise: C(0)=1, C(lag>0) ~ 0
    rng = np.random.default_rng(0)
    vn = rng.standard_normal((4000, 20, 3))
    cn = velocity_autocorrelation(vn, max_lag=5)
    assert cn[0] == 1.0
    assert np.all(np.abs(cn[1:]) < 0.01)


def test_diagnose_nan_triage():
    """diagnose_nan distinguishes the three poison causes (overflow /
    stale neighbor state / diverged coordinates) from the last finite
    state — the failure-detection triage the reference has no analog of."""
    import jax
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.neighbors import build_neighbor_state, skin_radius
    from chargeflux_tpu.utils import diagnose_nan, max_cell_occupancy

    force, pos, masses, box = water_box(n_side=10, seed=9)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    x = jnp.asarray(pos)

    # healthy state
    rep = diagnose_nan(x, system)
    assert rep["cause"] == "none"

    # diverged coordinates dominate every other check
    x_bad = x.at[0, 0].set(jnp.nan)
    assert diagnose_nan(x_bad, system)["cause"] == "non_finite_positions"

    # cell overflow: cram the first two molecules' worth of extra atoms
    # into one corner cell past a deliberately tiny capacity
    tiny = force.create_system(box=box, dtype=jnp.float64,
                               direct_method="cell", cell_capacity=8)
    occ = max_cell_occupancy(x, tiny)
    assert occ > 8  # liquid density: >8 atoms in the densest cell
    rep = diagnose_nan(x, tiny)
    assert rep["cause"] == "cell_overflow"
    assert rep["max_occupancy"] == occ
    assert rep["overflow"] > 0
    suggested = int(rep["suggestion"].split("cell_capacity=")[1].split(")")[0])
    assert suggested >= occ and suggested % 8 == 0
    ok = force.create_system(box=box, dtype=jnp.float64,
                             direct_method="cell", cell_capacity=suggested)
    assert diagnose_nan(x, ok)["cause"] == "none"

    # stale neighbor state: move one atom past skin/2 after the rebuild
    nb = build_neighbor_state(x, system)
    shift = 0.6 * float(skin_radius(system)) + 1e-3
    x_moved = x.at[0, 0].add(shift)
    rep = diagnose_nan(x_moved, system, nb=nb, dt=5e-4)
    assert rep["cause"] == "stale_neighbor_state"
    assert "rebuild_every" in rep["suggestion"]
    # the fresh state itself reads healthy through the same call
    assert diagnose_nan(x, system, nb=nb)["cause"] == "none"


def test_total_dipole_manual_and_translation_invariant():
    """M = sum q_i(x) x_i with *effective* charges; neutral system => M is
    translation-invariant (flux terms conserve charge by construction,
    reference ReferenceCoulKernels.cpp:60-62, 112-115, 188-193)."""
    from chargeflux_tpu.charges import effective_charges
    from chargeflux_tpu.utils import total_dipole

    force, pos, _ = water_cluster(n_side=2, flux="bond_angle", seed=5)
    system = force.create_system(dtype=jnp.float64)
    x = jnp.asarray(pos)
    m = total_dipole(x, system)
    q = np.asarray(effective_charges(x, system))
    np.testing.assert_allclose(np.asarray(m),
                               (q[:, None] * np.asarray(pos)).sum(0),
                               rtol=1e-14, atol=1e-14)
    m_shift = total_dipole(x + jnp.asarray([1.7, -0.4, 3.3]), system)
    np.testing.assert_allclose(np.asarray(m_shift), np.asarray(m),
                               rtol=0, atol=1e-12)


def test_total_dipole_sees_charge_flux():
    """Stretching an OH bond must change the dipole MORE than the
    fixed-charge geometric response alone — the flux contribution is the
    model's defining observable."""
    from chargeflux_tpu.utils import total_dipole

    force, pos, _ = water_cluster(n_side=1, flux="bond_angle", seed=9)
    system = force.create_system(dtype=jnp.float64)
    x0 = jnp.asarray(pos)
    stretch = jnp.zeros_like(x0).at[1].set(0.03 * (x0[1] - x0[0])
                                           / jnp.linalg.norm(x0[1] - x0[0]))
    x1 = x0 + stretch
    dm_full = np.asarray(total_dipole(x1, system) - total_dipole(x0, system))
    q0 = np.asarray(system.q0)
    dm_fixed = (q0[:, None] * (np.asarray(x1) - np.asarray(x0))).sum(0)
    # flux part = full response minus the fixed-charge geometric part
    assert np.linalg.norm(dm_full - dm_fixed) > 1e-4
    assert np.isfinite(dm_full).all()


def test_dipole_acf_and_ir_spectrum_limits():
    from chargeflux_tpu.utils import dipole_autocorrelation, infrared_spectrum

    # constant dipole: ACF identically 1
    m_const = np.tile(np.array([0.3, -0.1, 0.2]), (64, 1))
    np.testing.assert_allclose(dipole_autocorrelation(m_const, 10),
                               np.ones(11), atol=1e-12)
    # single-frequency oscillation: spectrum peaks at that frequency
    n, dt, f0 = 256, 0.002, 30.0  # ps, THz (bin 10 of rfftfreq)
    t = np.arange(n) * dt
    m = np.zeros((n, 3))
    m[:, 0] = np.cos(2 * np.pi * f0 * t)
    freq, inten = infrared_spectrum(m, dt)
    assert freq[np.argmax(inten)] == pytest.approx(f0, abs=freq[1])
    # ACF of the oscillation decorrelates and returns near +1 a period later
    acf = dipole_autocorrelation(m, int(1.0 / (f0 * dt)))
    assert acf[int(0.5 / (f0 * dt))] < -0.8
    # fluctuation semantics: a constant offset must not bias the ACF
    # (the mean is subtracted, matching infrared_spectrum)
    m_off = m + np.array([5.0, -3.0, 2.0])
    np.testing.assert_allclose(dipole_autocorrelation(m_off, 20),
                               dipole_autocorrelation(m, 20),
                               rtol=0, atol=1e-9)


def test_diagnose_nan_collinear_flux_angle():
    """Fourth triage cause: a (near-)collinear flux angle — finite energy,
    singular force (PARITY defect #2)."""
    from chargeflux_tpu.utils import diagnose_nan

    force = cf.CoulForce()
    a = force.addParticle(-0.8, 0.3, 0.5)
    b = force.addParticle(0.4, 0.2, 0.1)
    c = force.addParticle(0.4, 0.2, 0.1)
    force.addFluxAngle(a, b, c, 0.15, 1.9)
    system = force.create_system(dtype=jnp.float64)

    x = jnp.asarray([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0, 0]], jnp.float64)
    rep = diagnose_nan(x, system)
    assert rep["cause"] == "collinear_flux_angle"
    assert rep["angle_index"] == 0
    assert "1/sin" in rep["suggestion"]

    # a healthy bent angle reads none
    x_ok = x.at[2].set(jnp.asarray([0.1, 0.1, 0.0]))
    assert diagnose_nan(x_ok, system)["cause"] == "none"


def test_dcd_roundtrip_and_native_python_bit_equality(tmp_path, monkeypatch):
    """DCDWriter: frames + unit cells round-trip; the native C++ writer and
    the pure-Python fallback produce BIT-IDENTICAL files."""
    import chargeflux_tpu.runtime.native as native
    from chargeflux_tpu.utils import DCDWriter, read_dcd
    from chargeflux_tpu.utils.trajectory import _cell_record

    rng = np.random.default_rng(17)
    frames = rng.standard_normal((3, 11, 3))
    box = np.array([2.0, 2.5, 3.0])
    tri = np.array([[2.0, 0.0, 0.0], [0.4, 2.5, 0.0], [0.2, -0.3, 3.0]])

    def write(path):
        with DCDWriter(path, 11, dt_ps=0.002, interval=10) as w:
            w.write(frames[0], box=box)
            w.write(frames[1], box=tri)
            w.write(frames[2], box=box)
        return path

    p1 = write(str(tmp_path / "native.dcd"))
    got, cells = read_dcd(p1)
    assert got.shape == (3, 11, 3)
    # coordinates survive at f32 resolution (format precision)
    np.testing.assert_allclose(got, frames, atol=2e-7 * np.abs(frames).max())
    np.testing.assert_allclose(cells[0], [20.0, 90.0, 25.0, 90.0, 90.0, 30.0])
    np.testing.assert_allclose(cells[1], _cell_record(tri), rtol=1e-12)
    # triclinic angles really are non-orthogonal
    assert abs(cells[1][1] - 90.0) > 1.0

    used_native = native.native_available()
    monkeypatch.setattr(native, "dcd_native_handle", lambda *a: None)
    p2 = write(str(tmp_path / "python.dcd"))
    got2, cells2 = read_dcd(p2)
    np.testing.assert_array_equal(got, got2)
    if used_native:
        assert open(p1, "rb").read() == open(p2, "rb").read()


def test_pdb_round_trip_ortho_and_triclinic(tmp_path):
    """write_pdb -> read_pdb round-trips coordinates (to the format's
    1e-3 Angstrom column precision), CRYST1 boxes (orthorhombic -> [3],
    sheared -> reduced [3, 3] lattice), and multi-frame MODEL records."""
    from chargeflux_tpu.utils import read_pdb, write_pdb

    rng = np.random.default_rng(3)
    frames = rng.uniform(0.0, 1.8, (2, 6, 3))
    names = ["O", "H1", "H2", "O", "H1", "H2"]
    res = [1, 1, 1, 2, 2, 2]
    path = str(tmp_path / "box.pdb")
    n = write_pdb(path, frames, box=np.array([1.9, 2.1, 2.3]),
                  masses=[15.999, 1.008, 1.008] * 2, names=names,
                  resnames=["HOH"] * 6, resseq=res)
    assert n == 2
    pdb = read_pdb(path)
    assert pdb.frames.shape == (2, 6, 3)
    # format stores Angstroms at 1e-3 -> 1e-4 nm quantization
    np.testing.assert_allclose(pdb.frames, frames, atol=1.5e-4)
    assert pdb.symbols == ["O", "H", "H", "O", "H", "H"]
    assert pdb.names == names and pdb.resseq == res
    np.testing.assert_allclose(pdb.box, [1.9, 2.1, 2.3], atol=1e-4)

    lat = np.array([[2.0, 0.0, 0.0], [0.5, 2.2, 0.0], [0.3, -0.2, 2.4]])
    p2 = str(tmp_path / "tri.pdb")
    write_pdb(p2, frames[0], box=lat, symbols=pdb.symbols)
    back = read_pdb(p2)
    assert back.frames.shape == (1, 6, 3)
    # CRYST1 keeps lengths/angles only: the reduced lattice is recovered
    # up to the crystallographic frame; compare the Gram matrix.
    np.testing.assert_allclose(back.box @ back.box.T, lat @ lat.T,
                               rtol=2e-3)


def test_water_system_from_pdb_matches_builder(tmp_path):
    """A water box written to PDB (with scrambled within-residue atom
    order) rebuilds into a system with identical energy/forces to the
    direct builder."""
    from chargeflux_tpu.models import water_box, water_system_from_pdb
    from chargeflux_tpu.utils import write_pdb

    force, pos, masses, box = water_box(n_side=2)
    n_w = len(masses) // 3
    # scramble each residue to (H1, O, H2) order in the file
    perm_file = np.arange(3 * n_w).reshape(-1, 3)[:, [1, 0, 2]].reshape(-1)
    path = str(tmp_path / "w.pdb")
    write_pdb(path, pos[perm_file], box=box,
              masses=np.asarray(masses)[perm_file],
              names=["H1", "O", "H2"] * n_w, resnames=["HOH"] * (3 * n_w),
              resseq=np.repeat(np.arange(1, n_w + 1), 3))
    force2, pos2, masses2, box2, order = water_system_from_pdb(path)
    np.testing.assert_allclose(box2, box, atol=1e-4)
    np.testing.assert_allclose(pos2, pos, atol=1.5e-4)
    np.testing.assert_array_equal(masses2, masses)
    # order maps engine order back to file order (exact: both sides are
    # the file's quantized coordinates)
    from chargeflux_tpu.utils import read_pdb
    np.testing.assert_array_equal(np.asarray(pos2)[np.argsort(order)],
                                  read_pdb(path).positions)

    sys_a = force.create_system(box=box)
    sys_b = force2.create_system(box=box2)
    e_a = float(cf.energy(jnp.asarray(pos), sys_a))
    e_b = float(cf.energy(jnp.asarray(pos2), sys_b))
    # identical topology; only the 1e-4 nm PDB quantization separates them
    assert abs(e_a - e_b) < 5e-2 * max(1.0, abs(e_a))

    with pytest.raises(ValueError):
        write_pdb(str(tmp_path / "bad.pdb"), pos, names=["O"])


def test_water_from_pdb_survives_resseq_wrap(tmp_path):
    """PDB resseq wraps at 9999, so a >9999-water box repeats residue
    numbers.  Grouping must follow CONTIGUOUS (resname, resseq) runs, not
    a global dict key (which collides wrapped ids and dies with
    'expected 1 O + 2 H')."""
    from chargeflux_tpu.models import water_box, water_system_from_pdb
    from chargeflux_tpu.utils import write_pdb

    force, pos, masses, box = water_box(n_side=2)
    n_w = len(masses) // 3
    # simulate the wrap: residue ids restart mid-file
    resseq = np.repeat([1, 2, 3, 1, 2, 3, 1, 2][:n_w], 3)
    path = str(tmp_path / "wrap.pdb")
    write_pdb(path, pos, box=box, masses=masses,
              names=["O", "H1", "H2"] * n_w, resnames=["HOH"] * (3 * n_w),
              resseq=resseq)
    force2, pos2, masses2, box2, order = water_system_from_pdb(path)
    np.testing.assert_allclose(pos2, pos, atol=1.5e-4)
    np.testing.assert_array_equal(masses2, masses)


def test_read_pdb_two_letter_element_fallback(tmp_path):
    """When element columns 77-78 are empty, the atom-name fallback must
    keep two-letter elements (Cl, Na) and not misread hydrogens named
    HW1/1HH1)."""
    from chargeflux_tpu.utils import read_pdb

    lines = ["CRYST1   20.000   20.000   20.000  90.00  90.00  90.00 P 1"]
    # (name4, resname) pairs; coordinates arbitrary
    atoms = [("CL  ", "CL"), ("NA  ", "NA"), (" OW ", "HOH"),
             ("HW1 ", "HOH"), ("1HH1", "ARG"), (" CA ", "ALA")]
    for i, (nm, rn) in enumerate(atoms):
        lines.append(
            f"ATOM  {i + 1:>5} {nm} {rn:<3} A{i + 1:>4}    "
            f"{1.0 + i:8.3f}{2.0:8.3f}{3.0:8.3f}  1.00  0.00")
    path = str(tmp_path / "ions.pdb")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    pdb = read_pdb(path)
    assert pdb.symbols == ["Cl", "Na", "O", "H", "H", "C"]
