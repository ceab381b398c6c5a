"""End-to-end example: constant-pressure (NPT) water with charge flux.

Builds a periodic flexible-water box, equilibrates it at a target
temperature and pressure with the Langevin + Monte-Carlo-barostat driver
(npt.py), and reports the box/density trajectory, barostat acceptance and
the instantaneous virial pressure.  The reference plugin's users get this
from OpenMM's MonteCarloBarostat; here it is native (volume moves ride the
*traced* box through the already-compiled energy — no recompiles).

    python examples/run_npt.py [n_side] [n_steps] [pressure_bar] [--cpu]
                               [--anisotropic]

``--cpu`` forces the CPU backend (through the config update, which holds
even where an accelerator plugin is installed).
``--anisotropic`` swaps in the per-axis barostat
(npt_anisotropic_langevin_trajectory — the MonteCarloAnisotropicBarostat
analog) and reports the per-axis box and the virial pressure TENSOR
diagonal instead of the scalar.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

ANISO = "--anisotropic" in sys.argv
if ANISO:
    sys.argv.remove("--anisotropic")

import jax.numpy as jnp

import chargeflux_tpu as cf
from chargeflux_tpu.models import water_bonded_params, water_box
from chargeflux_tpu.npt import (instantaneous_pressure,
                                npt_anisotropic_langevin_trajectory,
                                npt_langevin_trajectory, pressure_tensor)

# water: 18.015 g/mol -> kg per molecule x molecules per nm^3 = kg/m^3
_KG_M3_PER_MOL_NM3 = 18.015 / 0.602214076


def main():
    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
    pressure = float(sys.argv[3]) if len(sys.argv) > 3 else 1.0
    temperature = 300.0  # K
    dt = 2e-4            # ps
    interval = 20        # MD steps per barostat attempt

    force, pos, masses, box = water_box(n_side=n_side, flux="bond_angle")
    n_w = n_side ** 3
    system = force.create_system(box=box, dtype=jnp.float32)
    bonded = water_bonded_params(n_w, box=box, dtype=jnp.float32)
    masses_j = jnp.asarray(np.asarray(masses), jnp.float32)

    v0 = cf.maxwell_velocities(masses_j, temperature, jax.random.PRNGKey(1))
    x0 = jnp.asarray(pos, jnp.float32)

    driver = (npt_anisotropic_langevin_trajectory if ANISO
              else npt_langevin_trajectory)
    x1, v1, box1, diag = driver(
        x0, v0, system, masses_j, dt=dt, temperature=temperature,
        friction=2.0, pressure_bar=pressure, key=jax.random.PRNGKey(0),
        n_steps=n_steps, bonded=bonded, barostat_interval=interval)

    boxes = np.asarray(diag["boxes"])
    vols = boxes.prod(axis=1)
    acc = np.asarray(diag["accepts"])
    dens = n_w * _KG_M3_PER_MOL_NM3 / vols
    print(f"{n_w * 3} atoms | {n_steps} steps at {dt * 1e3:.2f} fs | "
          f"P = {pressure} bar, T = {temperature} K")
    print(f"box: {np.asarray(system.box)[0]:.4f} -> {boxes[-1][0]:.4f} nm | "
          f"density {dens[0]:.0f} -> {dens[-1]:.0f} kg/m^3")
    print(f"barostat acceptance {acc.mean():.2f} "
          f"({int(acc.sum())}/{len(acc)} moves)")
    p_inst = float(instantaneous_pressure(
        x1, v1, system.with_box(box1), masses_j, bonded=bonded))
    e_last = float(np.asarray(diag["energies"])[-1])
    print(f"final total E {e_last:.1f} kJ/mol | instantaneous virial "
          f"pressure {p_inst:.0f} bar (single-config; NPT average ~ P_ext)")
    if ANISO:
        P = np.asarray(pressure_tensor(x1, v1, system.with_box(box1),
                                       masses_j, bonded=bonded))
        print(f"final box diag {np.round(np.asarray(box1), 4)} | stress "
              f"diag {np.round(np.diag(P), 0)} bar | attempted axes "
              f"{np.asarray(diag['axes'])}")
    assert np.isfinite(e_last)

    # final-frame structure + a viewable trajectory frame
    from chargeflux_tpu.utils import radial_distribution, write_xyz
    write_xyz("npt_final.xyz", np.asarray(x1), masses=np.asarray(masses),
              comments=[f"NPT final frame, box {np.asarray(box1)[0]:.4f} nm"])
    o_idx = np.arange(0, system.n_atoms, 3)
    r, g = radial_distribution(x1, box1, o_idx, o_idx,
                               r_max=float(np.asarray(box1)[0]) / 2 - 1e-6,
                               n_bins=30)
    peak = int(np.argmax(np.asarray(g)))
    print(f"g_OO first peak ~{float(np.asarray(r)[peak]):.2f} nm "
          f"(height {float(np.asarray(g)[peak]):.1f}); frame written to "
          f"npt_final.xyz")


if __name__ == "__main__":
    main()
