"""bench.py config plumbing: the capacity re-provision must preserve
every trace-time override of the original spec.

Regression: _with_capacity once dropped cell_grid/pme_grid, silently
rebuilding the forced 8^3 splitting-knob grid as the derived 9^3 grid
whenever burn-in re-provisioned capacity — the bench then measured a
different program than the config it reports."""

import sys

import jax.numpy as jnp
import numpy as np


def _bench():
    sys.path.insert(0, ".")
    import bench
    return bench


def test_with_capacity_preserves_spec_overrides():
    bench = _bench()
    x, system, masses, force = bench.build_full("30k")
    assert system.spec.cell_grid == (8, 8, 8)   # the forced splitting grid
    s2 = bench._with_capacity(force, system, system.spec.cell_capacity + 8)
    assert s2.spec.cell_capacity == system.spec.cell_capacity + 8
    assert s2.spec.cell_grid == system.spec.cell_grid
    assert s2.spec.pme_grid == system.spec.pme_grid
    assert s2.spec.recip_method == system.spec.recip_method
    assert s2.spec.walk_layout == system.spec.walk_layout
    assert s2.spec.cutoff == system.spec.cutoff


def test_pme_grid_rejected_on_kmax_routes():
    import pytest

    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=3, cutoff=0.4)
    with pytest.raises(ValueError, match="kmax-Ewald"):
        force.create_system(box=box, dtype=jnp.float32,
                            recip_method="xla", pme_grid=(64, 64, 64))
