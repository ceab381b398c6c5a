"""Test configuration: run on a virtual 8-device CPU mesh in float64.

The multi-device tests follow SURVEY §4.5 ("distributed without a cluster"):
XLA_FLAGS=--xla_force_host_platform_device_count=8 on the CPU backend.
Float64 is enabled so the JAX path can be compared against the NumPy oracle
at reference (CPU double) precision.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# The config update (not only the env var) pins the CPU backend even where
# an accelerator plugin is installed: the tests compare against f64 oracles.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: XLA CPU compiles are the dominant test
# cost; cache them across test processes.
from chargeflux_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(0.5)


# ---------------------------------------------------------------------------
# Suite tiering: tests that measured >=19 s in a full-suite timing run
# (--durations) are auto-marked `slow`, so `pytest -m "not slow"` is a <10 min correctness
# gate for inner-loop iteration; the full suite stays the pre-snapshot
# gate.  New long tests: either add pytest.mark.slow directly or extend
# this list.  Keyed on (file, name) so a future same-named fast test in
# another file is not silently skipped.  Fast-gate coverage
# note: the slow-marked test_template_matches_scatter_path and
# test_overflow_poisons_energy_in_jit invariants remain covered in the
# fast gate by test_topology.py::test_multi_template_random_mixtures_
# match_scatter (template==scatter parity) and test_cells.py's cheap
# overflow/poison unit tests — keep those fast if this list grows.
# ---------------------------------------------------------------------------

import pytest as _pytest

_SLOW_TESTS = {
    ("test_pme.py", "test_cell_blocked_spread_matches_dense"),
    ("test_triclinic.py", "test_cell_walk_matches_dense_on_triclinic"),
    ("test_neighbors.py", "test_energy_with_fresh_nb_matches_plain"),
    ("test_triclinic.py", "test_epsilon_shear_converges_to_orthorhombic"),
    ("test_triclinic.py", "test_f32_force_rmse_budget"),
    ("test_examples.py", "test_fast_examples_run"),
    ("test_halo.py", "test_halo_100k_cell_path_equality"),
    ("test_halo.py", "test_halo_collective_structure"),
    ("test_halo.py", "test_halo_devices_grid_rounding"),
    ("test_halo.py", "test_halo_forces_match_single_device"),
    ("test_halo.py", "test_halo_md_trajectory_matches_single_chip"),
    ("test_halo.py", "test_halo_pme_recip_matches_single_device"),
    ("test_triclinic.py", "test_halo_sharding_matches_on_triclinic"),
    ("test_thermostat.py", "test_langevin_nb_cell_route"),
    ("test_integrate.py", "test_langevin_nb_resume_exact"),
    ("test_multislice.py", "test_multislice_replica_energies_match"),
    ("test_neighbors.py", "test_nb_trajectory_matches_per_step_rebuild"),
    ("test_nosehoover.py", "test_nhc_nb_conserved_and_resume"),
    ("test_nosehoover.py", "test_nhc_resume_is_bitwise_exact"),
    ("test_npt.py", "test_npt_anisotropic_triclinic_row_scaling"),
    ("test_npt.py", "test_npt_langevin_cell_route"),
    ("test_npt.py", "test_npt_rigid_water_rattle"),
    ("test_npt.py", "test_npt_vmaps_over_replicas"),
    ("test_triclinic.py", "test_nve_neighbor_reuse_on_triclinic"),
    ("test_cells.py", "test_overflow_poisons_energy_in_jit"),
    ("test_neighbors.py", "test_packed_trajectory_matches_stepwise_api"),
    ("test_pme.py",
     "test_pme_slack_guard_poisons_excess_drift_under_box_growth"),
    ("test_npt.py", "test_pressure_cell_matches_dense"),
    ("test_npt.py", "test_pressure_coulomb_homogeneity"),
    ("test_npt.py", "test_pressure_lj_pair_analytic"),
    ("test_npt.py", "test_pressure_tensor_trace_and_symmetry"),
    ("test_integrate.py", "test_rattle_langevin_nb_resume_exact"),
    ("test_shard.py", "test_replica_nve_trajectory_matches_stepwise"),
    ("test_respa.py", "test_respa_langevin_thermalizes_cell_route"),
    ("test_constraints.py", "test_rigid_langevin_nb_cell_route"),
    ("test_salt_model.py", "test_salt_oracle_parity"),
    ("test_topology.py", "test_template_matches_scatter_path"),
    ("test_pme.py", "test_total_energy_with_pme_route"),
    ("test_dispersion.py", "test_virial_pressure_includes_tail_cell_route"),
    ("test_npt.py", "test_with_box_scaled_cell_route_oracle_parity"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        key = (item.fspath.basename, item.name.split("[")[0])
        if key in _SLOW_TESTS:
            item.add_marker(_pytest.mark.slow)
