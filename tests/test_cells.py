"""Cell-list direct-space sum == dense masked path (SURVEY §7 step 5)."""

import jax.numpy as jnp
import numpy as np
import pytest

import chargeflux_tpu as cf
from chargeflux_tpu.cells import build_cell_list, neighbor_cell_table, validate_cell_list
from chargeflux_tpu.models import water_box


def _box_system(method, n_side=4, cutoff=0.62, seed=13):
    # n_side=4 with spacing 0.3107 -> box 1.24 nm; cutoff 0.31*2 = 3+ cells/axis
    force, pos, _, box = water_box(n_side=n_side, flux="bond_angle",
                                   cutoff=cutoff, seed=seed,
                                   density_spacing=0.62)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method=method)
    return system, jnp.asarray(pos)


def test_cell_list_binning_covers_all_atoms():
    system, x = _box_system("cell")
    slots, overflow = build_cell_list(x, system.box, system.spec.cell_grid,
                                      system.spec.cell_capacity)
    assert int(overflow) == 0
    n = x.shape[0]
    ids = np.asarray(slots).ravel()
    real = ids[ids < n]
    assert len(real) == n
    assert len(np.unique(real)) == n
    assert validate_cell_list(x, system) == 0


def test_cell_list_overflow_detection():
    """Atoms beyond a cell's capacity are dropped and reported — the failure
    detection the reference entirely lacks (SURVEY §5)."""
    import chargeflux_tpu.cells as c

    force, pos, _, box = water_box(n_side=4, flux="bond_angle", cutoff=0.62,
                                   density_spacing=0.62, seed=14)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell", cell_capacity=2)
    x = jnp.asarray(pos)
    dropped = c.validate_cell_list(x, system)
    assert dropped > 0
    # and a roomy capacity drops nothing
    system2 = force.create_system(box=box, dtype=jnp.float64,
                                  direct_method="cell")
    assert c.validate_cell_list(x, system2) == 0


def test_neighbor_table_shape_and_wrap():
    tbl = neighbor_cell_table((3, 4, 5))
    assert tbl.shape == (60, 27)
    # every cell appears in its own neighbor list (the dz=dy=dx=0 entry)
    assert all(c in tbl[c] for c in range(60))


def test_cell_energy_matches_dense():
    sys_dense, x = _box_system("dense")
    sys_cell, _ = _box_system("cell")
    e_dense = float(cf.energy(x, sys_dense))
    e_cell = float(cf.energy(x, sys_cell))
    # The two routes regroup direct/exclusion terms of magnitude ~|self|;
    # agreement is relative to that scale (catastrophic cancellation makes
    # the tiny total an unusable yardstick).
    comps = cf.energy_components(x, sys_dense)
    scale = max(abs(float(v)) for v in comps.values())
    assert abs(e_cell - e_dense) <= 1e-12 * scale


def test_cell_forces_match_dense():
    sys_dense, x = _box_system("dense")
    sys_cell, _ = _box_system("cell")
    f_dense = np.asarray(cf.forces(x, sys_dense))
    f_cell = np.asarray(cf.forces(x, sys_cell))
    scale = np.abs(f_dense).max()
    np.testing.assert_allclose(f_cell / scale, f_dense / scale, atol=1e-12)


def test_cell_components_match_dense():
    sys_dense, x = _box_system("dense")
    sys_cell, _ = _box_system("cell")
    cd = cf.energy_components(x, sys_dense)
    cc = cf.energy_components(x, sys_cell)
    # direct+exclusion regroup between the two routes; their sum must agree
    # (the two-routes-one-contract note of SURVEY §5)
    assert float(cc["direct"] + cc["exclusion"]) == pytest.approx(
        float(cd["direct"] + cd["exclusion"]), rel=1e-12)
    assert float(cc["self"]) == pytest.approx(float(cd["self"]), rel=1e-14)
    assert float(cc["reciprocal"]) == pytest.approx(float(cd["reciprocal"]), rel=1e-14)


def test_overflow_poisons_energy_in_jit():
    """A cell past capacity must make the energy visibly NaN inside the jit
    step, not silently drop pair interactions."""
    import dataclasses

    from chargeflux_tpu.energy import _energy_and_forces

    force, pos, _, box = water_box(n_side=7, flux="bond_angle", cutoff=0.65,
                                   seed=5)
    system = force.create_system(box=box, dtype=jnp.float64,
                                 direct_method="cell")
    x = jnp.asarray(pos)
    e0, _ = _energy_and_forces(x, system)
    assert np.isfinite(float(e0))

    # shrink capacity below the densest cell -> overflow -> NaN energy AND
    # NaN forces (multiplicative poison: a force-only consumer must see
    # the failure too, not integrate quietly wrong gradients)
    tiny = dataclasses.replace(
        system, spec=dataclasses.replace(system.spec, cell_capacity=8))
    e1, f1 = _energy_and_forces(x, tiny)
    assert np.isnan(float(e1))
    assert np.all(np.isnan(np.asarray(f1)))


def test_binning_matches_numpy_reference_randomized():
    """Property test for the two-stage hierarchical binning: slots,
    inv_slot and overflow must match a direct NumPy ranking (rank = count
    of same-cell atoms with smaller atom id) across random shapes, grids
    and capacities — including forced-overflow cases, where every
    *retained* slot assignment must still be exact and overflow > 0."""
    rng = np.random.default_rng(123)
    cases = [
        (257, (3, 3, 3), 40),      # plenty of headroom
        (1000, (4, 3, 5), 24),     # odd mixed grid
        (500, (3, 4, 3), 8),       # guaranteed overflow
        (64, (5, 5, 5), 8),        # sparse: most cells empty
    ]
    for n, grid, cap in cases:
        box = jnp.asarray(rng.uniform(1.5, 3.0, 3))
        x = jnp.asarray(rng.uniform(-2.0, 4.0, (n, 3)))  # outside-box wraps
        from chargeflux_tpu.cells import build_cell_list_full
        slots, inv, ov = build_cell_list_full(x, box, grid, cap)
        slots, inv, ov = map(np.asarray, (slots, inv, ov))

        # NumPy reference ranking
        gx, gy, gz = grid
        # JAX computes the cell index in the array dtype; reproduce it
        fracj = np.asarray(x / box - jnp.floor(x / box))
        cij = np.clip((fracj * np.array(grid)).astype(np.int64), 0,
                      np.array(grid) - 1)
        cid = (cij[:, 0] * gy + cij[:, 1]) * gz + cij[:, 2]
        n_cells = gx * gy * gz
        ref_slots = np.full((n_cells, cap), n, np.int64)
        ref_inv = np.full(n, n_cells * cap, np.int64)
        counts = np.zeros(n_cells, np.int64)
        n_over = 0
        for i in range(n):
            c = cid[i]
            if counts[c] < cap:
                ref_slots[c, counts[c]] = i
                ref_inv[i] = c * cap + counts[c]
            else:
                n_over += 1
            counts[c] += 1

        assert int(ov) > 0 if n_over > 0 else int(ov) == 0, (n, grid, cap)
        if n_over == 0:
            np.testing.assert_array_equal(slots, ref_slots)
            np.testing.assert_array_equal(inv, ref_inv)
        else:
            # Overflowing builds are poisoned by the energy path, so the
            # retained SUBSET may differ from pure per-cell ranking (stage
            # A drops by column rank) — but the count must not understate
            # (>= the per-cell drop count) and the retained layout must
            # keep its invariants: right cell, rank-contiguous from slot
            # 0 in increasing atom order, inv consistent with slots.
            assert int(ov) >= n_over
            for c in range(n_cells):
                row = slots[c]
                real = row[row < n]
                assert np.all(row[len(real):] == n)        # contiguity
                assert np.all(np.diff(real) > 0)           # atom order
                assert np.all(cid[real] == c)              # right cell
                for r, a in enumerate(real):
                    assert inv[a] == c * cap + r


def test_walk_layouts_agree():
    """shift (14 per-shift tiles) and concat (one j-super-slab tile) are
    the same sum in a different order; both must match, with and without
    the leading-axis chunking (spec.walk_chunks)."""
    import dataclasses

    sys_cat, x = _box_system("cell")   # create_system default = concat
    force, pos, _, box = water_box(n_side=4, flux="bond_angle",
                                   cutoff=0.62, seed=13,
                                   density_spacing=0.62)
    sys_shift = force.create_system(box=box, dtype=jnp.float64,
                                    direct_method="cell",
                                    walk_layout="shift")
    assert sys_cat.spec.walk_layout == "concat"
    gx = sys_cat.spec.cell_grid[0]
    sys_chunked = dataclasses.replace(
        sys_cat, spec=dataclasses.replace(sys_cat.spec, walk_chunks=gx))

    e0, f0 = cf.energy_and_forces(x, sys_shift)
    scale = float(jnp.max(jnp.abs(f0)))
    for s in (sys_cat, sys_chunked):
        e, f = cf.energy_and_forces(x, s)
        assert abs(float(e - e0)) <= 1e-10 * abs(float(e0))
        np.testing.assert_allclose(np.asarray(f) / scale,
                                   np.asarray(f0) / scale, atol=1e-12)
        # energy-only exercises the primal (non-fused) path
        assert abs(float(cf.energy(x, s) - cf.energy(x, sys_shift))) \
            <= 1e-10 * abs(float(e0))


def test_walk_layout_rejects_removed_variants():
    """The removed matmul-offload layouts (concat_hyb / concat_mxu) and
    ifull are rejected; the builder names them in its error so users find
    the history."""
    force, pos, _, box = water_box(n_side=4, seed=3)
    for layout in ("concat_hyb", "concat_mxu", "ifull", "bogus"):
        with pytest.raises(ValueError, match="walk_layout"):
            force.create_system(box=box, dtype=jnp.float32,
                                direct_method="cell", walk_layout=layout)


@pytest.mark.parametrize("force_sort", [False, True])
def test_rank_into_slots_masked_branches(force_sort):
    """Both ranking branches (two-stage one-hot / sort fallback) honor the
    ownership mask: every owned atom is placed exactly once or counted in
    overflow, unowned atoms never appear, slot_of inverts slots."""
    import jax

    from chargeflux_tpu.cells import rank_into_slots

    rng = np.random.default_rng(4)
    if force_sort:
        # n * ncol > 256M pushes the gate to the sort branch
        n, ncol, gz, cap = 300_000, 1000, 2, 192
    else:
        n, ncol, gz, cap = 20_000, 16, 4, 512
    col = jnp.asarray(rng.integers(0, ncol, n), jnp.int32)
    cz = jnp.asarray(rng.integers(0, gz, n), jnp.int32)
    owned = jnp.asarray(rng.random(n) < 0.7)
    slots, slot_of, overflow = jax.jit(
        rank_into_slots, static_argnums=(3, 4, 5, 6))(
        col, cz, owned, n, ncol, gz, cap)

    slots_np = np.asarray(slots)
    placed = slots_np[slots_np < n]
    own_np = np.asarray(owned)
    assert len(placed) == len(set(placed.tolist()))      # unique
    assert np.all(own_np[placed])                        # owned only
    assert len(placed) + int(overflow) == int(own_np.sum())
    # slot_of inverts slots for placed atoms; sentinel for the rest
    sof = np.asarray(slot_of)
    flat = slots_np.ravel()
    assert np.all(flat[sof[placed]] == placed)
    sentinel = ncol * gz * cap
    unplaced = np.ones(n, bool)
    unplaced[placed] = False
    assert np.all(sof[unplaced] == sentinel)
    # every placed atom sits in its own cell's row
    cells_of_slot = np.repeat(np.arange(ncol * gz), cap).reshape(
        ncol * gz, cap)
    cid = np.asarray(col) * gz + np.asarray(cz)
    mask = slots_np < n
    assert np.all(cells_of_slot[mask] == cid[slots_np[mask]])


def test_cell_grid_override_matches_default():
    """create_system(cell_grid=...) may reduce axes (wider cells keep
    coverage) or raise them up to the zero-skin bound floor(width/cutoff)
    (thinner Verlet skin, guarded by the freshness poison) —
    energies/forces must be identical to the derived grid either way;
    past the zero-skin bound it must raise (cells below the cutoff would
    miss pairs).  Expert knob for the device's tiled layouts."""
    force, pos, _, box = water_box(n_side=10, flux="bond_angle", cutoff=0.6,
                                   seed=8)
    x = jnp.asarray(pos)
    sys_a = force.create_system(box=box, dtype=jnp.float64,
                                direct_method="cell")
    assert sys_a.spec.cell_grid == (4, 4, 4)
    e_a, f_a = cf.energy_and_forces(x, sys_a)
    scale = float(np.max(np.abs(np.asarray(f_a))))
    # reduction (4,4,3) and zero-skin-bounded raise (5,4,4): both exact
    for g in ((4, 4, 3), (5, 4, 4)):
        sys_b = force.create_system(box=box, dtype=jnp.float64,
                                    direct_method="cell", cell_grid=g)
        assert sys_b.spec.cell_grid == g
        e_b, f_b = cf.energy_and_forces(x, sys_b)
        assert abs(float(e_a - e_b)) <= 1e-10 * abs(float(e_a))
        np.testing.assert_allclose(np.asarray(f_b) / scale,
                                   np.asarray(f_a) / scale, atol=1e-12)
    with pytest.raises(ValueError, match="zero-skin"):
        force.create_system(box=box, dtype=jnp.float64,
                            direct_method="cell", cell_grid=(6, 4, 4))
