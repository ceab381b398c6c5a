"""chargeflux_tpu — charge-flux electrostatics engine in JAX.

A standalone JAX/XLA rebuild of the capabilities of the openmm-chargeflux
plugin (geometry-dependent charges with analytic charge-flux forces, Ewald
electrostatics, LJ, exclusions): the whole energy/force step is one
jit-compiled function, the reciprocal space is smooth particle-mesh Ewald
(classical Ewald as one GEMM for f64 parity), the direct-space sum is a
fixed-capacity cell list, and scale-out goes through jax.sharding meshes.
"""

from .system import ChargeFluxSystem, CoulForce, StaticSpec, ewald_alpha, ewald_kmax
from .charges import effective_charges, charge_jacobian_values, jacobian_index_layout
from .energy import (
    energy,
    energy_and_forces,
    energy_components,
    energy_fixed_charges,
    forces,
    forces_manual,
)
from .bonded import (BondedParams, bonded_energy,
                     flat_bottom_restraint_energy,
                     position_restraint_energy)
from .constraints import (
    DistanceConstraints,
    RigidWaterParams,
    project_positions,
    project_velocities,
    rattle_langevin_trajectory,
    rattle_langevin_trajectory_nb,
    rattle_nve_trajectory,
    rattle_verlet_step,
)
from .integrate import (
    init_state,
    init_state_nb,
    kinetic_energy,
    langevin_step,
    langevin_trajectory,
    langevin_trajectory_nb,
    make_energy_fn,
    make_nb_energy_fn,
    make_respa_force_fns,
    maxwell_velocities,
    minimize_fire,
    nve_step,
    nve_step_nb,
    nve_trajectory,
    nve_trajectory_nb,
    remove_com_motion,
    respa_langevin_trajectory_nb,
    respa_trajectory_nb,
    temperature,
)
from .nosehoover import (NHChain, nhc_conserved, nhc_init,
                         nose_hoover_step, nose_hoover_trajectory,
                         nose_hoover_trajectory_nb)
from .csvr import csvr_trajectory, csvr_trajectory_nb
from .rbe import (make_rbe_nb_energy_fn, rbe_langevin_trajectory_nb,
                  rbe_reciprocal_energy, rbe_tables)
from .npt import (instantaneous_pressure, molecule_index,
                  npt_anisotropic_langevin_trajectory,
                  npt_langevin_trajectory, pressure_tensor)
from .units import ONE_4PI_EPS0, BOLTZ

__version__ = "0.1.0"

__all__ = [
    "ChargeFluxSystem", "CoulForce", "StaticSpec",
    "ewald_alpha", "ewald_kmax",
    "effective_charges", "charge_jacobian_values", "jacobian_index_layout",
    "energy", "energy_and_forces", "energy_components", "energy_fixed_charges",
    "forces", "forces_manual",
    "BondedParams", "bonded_energy", "flat_bottom_restraint_energy",
    "position_restraint_energy",
    "DistanceConstraints", "RigidWaterParams", "project_positions",
    "project_velocities",
    "rattle_verlet_step", "rattle_nve_trajectory",
    "rattle_langevin_trajectory", "rattle_langevin_trajectory_nb",
    "make_energy_fn", "nve_step", "nve_trajectory", "init_state",
    "make_nb_energy_fn", "nve_step_nb", "nve_trajectory_nb", "remove_com_motion", "init_state_nb",
    "langevin_step", "langevin_trajectory", "langevin_trajectory_nb",
    "make_respa_force_fns", "respa_trajectory_nb",
    "respa_langevin_trajectory_nb",
    "minimize_fire",
    "kinetic_energy", "temperature", "maxwell_velocities",
    "NHChain", "nhc_init", "nhc_conserved", "nose_hoover_step",
    "nose_hoover_trajectory", "nose_hoover_trajectory_nb",
    "csvr_trajectory", "csvr_trajectory_nb",
    "make_rbe_nb_energy_fn", "rbe_langevin_trajectory_nb",
    "rbe_reciprocal_energy", "rbe_tables",
    "instantaneous_pressure", "molecule_index",
    "npt_anisotropic_langevin_trajectory", "npt_langevin_trajectory",
    "pressure_tensor",
    "ONE_4PI_EPS0", "BOLTZ",
]
