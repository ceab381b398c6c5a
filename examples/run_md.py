"""End-to-end example: flexible-water NVE MD with charge-flux electrostatics.

Builds a periodic water box, runs velocity-Verlet NVE with the full
charge-flux Ewald potential + harmonic bonded terms, checkpoints the final
state, and reports energy conservation.

    python examples/run_md.py [n_side] [n_steps] [--cpu] [--pdb file.pdb]

``--pdb`` starts from a water-box PDB file instead of the generated
lattice (models.water_system_from_pdb; the OpenMM PDBFile workflow).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

# Strip the "--pdb <path>" pair before positional parsing (int(sys.argv[1])
# would otherwise choke on the flag itself).
PDB_PATH = None
if "--pdb" in sys.argv:
    i = sys.argv.index("--pdb")
    if i + 1 >= len(sys.argv):
        raise SystemExit("--pdb needs a file path operand")
    PDB_PATH = sys.argv[i + 1]
    del sys.argv[i:i + 2]

import jax.numpy as jnp

import chargeflux_tpu as cf
from chargeflux_tpu.integrate import (
    init_state, kinetic_energy, make_energy_fn, nve_trajectory)
from chargeflux_tpu.models import water_bonded_params, water_box
from chargeflux_tpu.utils import save_checkpoint


def main():
    n_side = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    temperature = 150.0  # K
    dt = 5e-5            # ps

    if PDB_PATH is not None:
        from chargeflux_tpu.models import water_system_from_pdb
        force, pos, masses, box, _ = water_system_from_pdb(PDB_PATH)
        if box is None:
            raise SystemExit("--pdb input needs a CRYST1 periodic cell")
        n_w = len(masses) // 3
    else:
        force, pos, masses, box = water_box(n_side=n_side,
                                            flux="bond_angle")
        n_w = n_side ** 3
    system = force.create_system(box=box, dtype=jnp.float32)
    if system.spec.direct_method == "cell":
        # lattice starts alias against the cell grid; size the capacity
        # from the actual configuration with margin (cells.suggest_capacity)
        from chargeflux_tpu.cells import suggest_capacity
        cap = suggest_capacity(pos, box, system.spec.cell_grid, margin=1.25)
        if cap > system.spec.cell_capacity:
            system = force.create_system(box=box, dtype=jnp.float32,
                                         cell_capacity=cap)
    bonded = water_bonded_params(n_w, box=box, dtype=jnp.float32)
    e_fn = make_energy_fn(system, bonded)

    rng = np.random.default_rng(0)
    sigma_v = np.sqrt(cf.BOLTZ * temperature / masses)[:, None]
    v0 = jnp.asarray(sigma_v * rng.standard_normal((len(masses), 3)),
                     jnp.float32)
    m = jnp.asarray(masses, jnp.float32)
    state = init_state(jnp.asarray(pos, jnp.float32), v0, e_fn)
    e0 = float(state.potential + kinetic_energy(state.velocities, m))
    print(f"{3 * n_w} atoms | E0 = {e0:.3f} kJ/mol | kmax={system.spec.kmax}")

    traj = jax.jit(nve_trajectory, static_argnames=("energy_fn", "n_steps"))
    t0 = time.perf_counter()
    final, etots = traj(state, energy_fn=e_fn, masses=m, dt=dt,
                        n_steps=n_steps)
    drift = float(jnp.max(jnp.abs(etots - e0)))
    elapsed = time.perf_counter() - t0
    print(f"{n_steps} steps in {elapsed:.2f} s "
          f"({elapsed / n_steps * 1e3:.3f} ms/step incl. compile)")
    print(f"max |E - E0| = {drift:.4f} kJ/mol")

    save_checkpoint("md_state", final, step=n_steps,
                    extra={"dt": dt, "n_side": n_side})
    print("checkpoint written to md_state.npz")


if __name__ == "__main__":
    main()
