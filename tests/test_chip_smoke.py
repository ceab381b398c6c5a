"""chip_smoke.py rehearsed on the CPU: the device check refuses the CPU,
and the phase functions run end to end at a tiny size (called directly,
not through ``main()``, which needs a GPU)."""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _smoke():
    sys.path.insert(0, ".")
    import chip_smoke
    return chip_smoke


def test_device_check_raises_off_gpu():
    smoke = _smoke()
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        smoke.phase_device()
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        smoke.main([])


def _tiny_cell_build():
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.models import water_box

    force, pos, masses, box = water_box(n_side=7, flux="bond_angle",
                                        cutoff=0.65, seed=13)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell")
    cap = suggest_capacity(pos, box, system.spec.cell_grid, margin=1.05)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell", cell_capacity=cap)
    return (jnp.asarray(pos, jnp.float32), system,
            jnp.asarray(masses, jnp.float32), force)


def test_main_path_and_correctness_phases_rehearsal(capsys):
    """Phases (b) and (c) on a 1,029-atom cell-route box: the timed NVE
    window stays finite and both f32 routes hold the force budget
    against the f64 reference at the state the window ends in."""
    smoke = _smoke()
    x, system, masses, force = _tiny_cell_build()
    res = smoke.phase_main("b", x, system, masses, force, "cpu rehearsal")
    assert np.isfinite(res.energy) and res.ms_per_step > 0
    assert res.positions.shape == x.shape
    assert not np.allclose(np.asarray(res.positions), np.asarray(x))
    errs = smoke.phase_correctness("c", res.positions, res.system, force,
                                   ("pme", "xla"))
    assert set(errs) == {"pme", "xla"}
    assert all(v[1] <= smoke.FORCE_RMSE_BUDGET for v in errs.values())
    out = capsys.readouterr().out
    assert "recip=pme" in out and "ms_per_step=" in out


def test_dense_phase_rehearsal():
    """Phase (d) on the 216-water dense box, as main() builds it."""
    import bench

    smoke = _smoke()
    x, system, masses, force = bench.build_full("216")
    assert system.spec.direct_method == "dense"
    res = smoke.phase_main("d", x, system, masses, force, "cpu rehearsal")
    errs = smoke.phase_correctness("d", res.positions, res.system, force,
                                   ("xla",))
    assert errs["xla"][1] <= smoke.FORCE_RMSE_BUDGET


def test_correctness_phase_fails_over_budget(monkeypatch):
    """The force budget is a gate: over it, phase (c) raises."""
    smoke = _smoke()
    x, system, _, force = _tiny_cell_build()
    monkeypatch.setattr(smoke, "FORCE_RMSE_BUDGET", 1e-12)
    with pytest.raises(RuntimeError, match="over budget"):
        smoke.phase_correctness("c", x, system, force, ("pme",))


def test_four_card_phase_rehearsal():
    """Phase (e) on four virtual CPU devices at a small box: the halo
    route is taken, every device owns a slab, and halo energy and forces
    match one device within the stated tolerance."""
    smoke = _smoke()
    x, system = smoke.four_card_system(n_side=8, cutoff=0.29, ndev=4)
    from chargeflux_tpu.parallel.halo import halo_compatible
    from chargeflux_tpu.pme import pme_halo_mesh

    assert halo_compatible(system, 4)
    assert pme_halo_mesh(system.spec) == system.spec.pme_grid
    de_atom, rel_f = smoke.phase_four(x, system, jax.devices()[:4],
                                      "cpu rehearsal")
    assert de_atom <= smoke.HALO_ENERGY_TOL_PER_ATOM
    assert rel_f <= smoke.HALO_FORCE_RMSE_TOL
