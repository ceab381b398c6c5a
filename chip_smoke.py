"""Smoke check on the card: the charge-flux MD main path at full size.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py          # one card: phases (a)-(d)
    python chip_smoke.py --four   # four cards: phase (e) only

(a) Device: JAX's first device must be a GPU; any other platform fails
    (there is no CPU fallback).  Prints the card's name and power limit.
(b) Main path: the 31,944-atom flexible-water box (``bench.build_full``:
    cell direct space + PME, f32) through ``make_nb_energy_fn`` and the
    packed NVE chunk that ``bench.measure_md_step`` drives: compile time,
    memory analysis, ms/step, ns/day, peak device memory; every energy of
    the timed window must be finite.
(c) Correctness at 30k, at the state (b) ends in: the f32 routes users
    run (``recip_method`` "pme" and "xla") against the f64 engine (cell
    direct space + classical Ewald, which tests/test_runtime_native.py pins
    to the native C++ oracle).  Fails above 1e-4 relative force RMSE.
(d) The 216-water dense box: ms/step, and f32 against f64 as in (c).
(e) ``--four``: the 98,304-atom box over four cards through the halo +
    distributed-PME route, against the same system on one card.

Every phase raises on failure, so the script exits non-zero before its
last line, which is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

import bench
from chargeflux_tpu.energy import energy_and_forces, resolve_recip_method
from chargeflux_tpu.ewald import F32_DOT_PRECISION

#: f32 force error budget against f64: relative force RMSE,
#: rms(f32 - f64) / rms(f64) (tests/test_pme.py).
FORCE_RMSE_BUDGET = 1e-4
#: halo route against one card, both f32 on one mesh: only the order of
#: the sums differs, so agreement is held far inside the f32 budget.  The
#: energy is compared per atom (kJ/mol): a box's total can cancel to a
#: small number, its per-atom terms (~100 kJ/mol) do not.
HALO_ENERGY_TOL_PER_ATOM = 1e-4
HALO_FORCE_RMSE_TOL = 1e-5


def peak_bytes(device=None):
    """``peak_bytes_in_use`` of ``device`` (default: the first), or None
    where the backend keeps no such statistic."""
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def phase_device():
    """(a) JAX's first device, which must be a GPU."""
    dev = bench.require_gpu()
    print(f"(a) device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    return dev


def phase_main(label, x, system, masses, force, card):
    """(b)/(d) timing: ``bench.measure_md_step`` (burn-in on the cell
    route, capacity re-provision, a timed window ending in a host sync).
    Returns its :class:`bench.MDStepResult`."""
    res = bench.measure_md_step(x, system, masses, force=force)
    ns_day = bench.DT_PS * 1e-3 * 86400.0 * 1000.0 / res.ms_per_step
    print(f"({label}) atoms={system.n_atoms} "
          f"direct={system.spec.direct_method} "
          f"recip={resolve_recip_method(system.spec, x.dtype)} "
          f"grid={system.spec.cell_grid} cap={system.spec.cell_capacity} "
          f"rebuild_every={res.rebuild_every}")
    print(f"({label}) compile_s={res.compile_s:.1f} "
          f"memory_analysis: {res.memory}")
    print(f"({label}) ms_per_step={res.ms_per_step:.4f} "
          f"ns_per_day={ns_day:.2f} peak_bytes_in_use={peak_bytes()} "
          f"[{card}]")
    if not np.isfinite(res.energy):
        raise RuntimeError(f"({label}) non-finite energy in the timed "
                           f"window: {res.energy}")
    return res


def _f64_reference(force, system, x):
    """(energy, forces) of the f64 engine: the same model, cell or dense
    direct space as ``system``, classical Ewald."""
    spec = system.spec
    kw = {}
    if spec.direct_method == "cell":
        kw = {"cell_grid": spec.cell_grid,
              "cell_capacity": spec.cell_capacity}
    with jax.enable_x64(True):
        sys64 = force.create_system(
            box=np.asarray(jax.device_get(system.box), np.float64),
            dtype=jnp.float64, direct_method=spec.direct_method,
            recip_method="xla", **kw)
        x64 = jnp.asarray(np.asarray(x, np.float64))
        e, f = energy_and_forces(x64, sys64)
        return float(e), np.asarray(f, np.float64)


def phase_correctness(label, x, system, force, routes):
    """(c)/(d) correctness: the f32 program for each reciprocal route in
    ``routes`` against the f64 reference at positions ``x``.  Raises
    above the force budget; returns {route: (rel_energy, rel_force_rmse)}.

    The f32 programs are traced first, as users run them (64-bit mode as
    the process set it); the f64 reference follows inside
    ``jax.enable_x64``."""
    x32 = jnp.asarray(x, jnp.float32)
    f32_out = {}
    for route in routes:
        sys_r = dataclasses.replace(
            system, spec=dataclasses.replace(system.spec,
                                             recip_method=route))
        e, f = energy_and_forces(x32, sys_r)
        f32_out[route] = (float(e), np.asarray(f, np.float64))
    e64, f64 = _f64_reference(force, system, x)
    rms = float(np.sqrt(np.mean(f64 ** 2)))
    errs = {}
    for route, (e32, f32) in f32_out.items():
        rel_e = abs(e32 - e64) / abs(e64)
        rel_f = float(np.sqrt(np.mean((f32 - f64) ** 2))) / rms
        errs[route] = (rel_e, rel_f)
        print(f"({label}) f32 recip={route} vs f64: rel_energy={rel_e:.3e} "
              f"rel_force_rmse={rel_f:.3e} (budget {FORCE_RMSE_BUDGET:g}) "
              f"f32_dot={F32_DOT_PRECISION.name}")
    bad = {r: v for r, v in errs.items() if not v[1] <= FORCE_RMSE_BUDGET}
    if bad:
        raise RuntimeError(f"({label}) f32 force RMSE over budget: {bad}")
    return errs


def four_card_system(n_side=32, cutoff=0.8, ndev=4):
    """The halo-sized f32 water box (default 98,304 atoms) with its PME
    mesh aligned to the cell grid, so the halo route's mesh and the
    single-card mesh are one and the two routes differ only in the order
    of their sums.  Returns (x, system)."""
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.models import water_box
    from chargeflux_tpu.parallel.halo import halo_decomp
    from chargeflux_tpu.pme import pme_halo_mesh

    force, pos, _, box = water_box(n_side=n_side, flux="bond_angle",
                                   cutoff=cutoff)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 halo_devices=ndev)
    pad_y = halo_decomp(system, ndev)[1] > 1
    mesh = pme_halo_mesh(system.spec, pad_y=pad_y)
    cap = max(system.spec.cell_capacity,
              suggest_capacity(pos, box, system.spec.cell_grid,
                               margin=1.05))
    system = force.create_system(box=box, dtype=jnp.float32,
                                 halo_devices=ndev, pme_grid=mesh,
                                 cell_capacity=cap)
    return jnp.asarray(pos, jnp.float32), system


def phase_four(x, system, devices, card):
    """(e) the halo + distributed-PME route over ``devices`` (a flat
    "space" mesh) against the same system on the first device alone.
    Raises when the route is not the halo path, when a device holds no
    slab of its own, or when energy or forces disagree beyond the stated
    tolerance.  Returns (energy difference per atom, rel_force_rmse)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from chargeflux_tpu.parallel import make_sharded_energy_fn
    from chargeflux_tpu.parallel.halo import (_local_bin, halo_compatible,
                                              halo_decomp)

    ndev = len(devices)
    if not halo_compatible(system, ndev):
        raise RuntimeError(f"(e) grid {system.spec.cell_grid} does not "
                           f"decompose over {ndev} devices: "
                           f"make_sharded_energy_fn would take work "
                           f"sharding, not the halo path")
    route = resolve_recip_method(system.spec, x.dtype)
    if route != "pme":
        raise RuntimeError(f"(e) resolved reciprocal route {route!r}, "
                           f"expected the distributed SPME")
    mesh = Mesh(np.asarray(devices), ("space",))
    ddx, ddy = halo_decomp(system, ndev)
    gx, gy, _ = system.spec.cell_grid
    print(f"(e) atoms={system.n_atoms} grid={system.spec.cell_grid} "
          f"cap={system.spec.cell_capacity} decomp=({ddx}, {ddy}) "
          f"pme_mesh={system.spec.pme_grid} recip={route} devices={ndev}")

    e_fn = make_sharded_energy_fn(system, mesh, axis_name="space")
    t0 = time.perf_counter()
    vg = jax.jit(jax.value_and_grad(e_fn)).lower(x).compile()
    compile_s = time.perf_counter() - t0
    e_h, g_h = jax.block_until_ready(vg(x))
    peaks = [peak_bytes(d) for d in devices]
    print(f"(e) halo compile_s={compile_s:.1f} peak_bytes_in_use per "
          f"device={peaks} [{card}]")

    # each device bins and owns its own slab (the halo route's binning)
    n = system.n_atoms

    def owned(positions):
        dev = jax.lax.axis_index("space")
        slots, _, _ = _local_bin(positions, system, dev // ddy, dev % ddy,
                                 gx // ddx, gy // ddy)
        return jnp.sum(slots < n)[None]

    counts = jax.jit(jax.shard_map(owned, mesh=mesh, in_specs=P(),
                                   out_specs=P("space")))(x)
    holders = {s.device for s in counts.addressable_shards}
    counts = np.asarray(counts)
    print(f"(e) atoms owned per device={counts.tolist()}")
    if (len(holders) != ndev or int(counts.sum()) != n
            or counts.min() < n // (2 * ndev)):
        raise RuntimeError(f"(e) slabs not spread over the devices: "
                           f"counts {counts.tolist()} on {len(holders)} "
                           f"devices")

    with jax.default_device(devices[0]):
        e_1, f_1 = energy_and_forces(x, system)
    e_1 = float(e_1)
    f_1 = np.asarray(f_1, np.float64)
    f_h = -np.asarray(g_h, np.float64)
    de_atom = abs(float(e_h) - e_1) / n
    rel_f = (float(np.sqrt(np.mean((f_h - f_1) ** 2)))
             / float(np.sqrt(np.mean(f_1 ** 2))))
    print(f"(e) halo vs one card: energy {float(e_h):.6f} vs {e_1:.6f} "
          f"kJ/mol, difference per atom={de_atom:.3e} "
          f"(tol {HALO_ENERGY_TOL_PER_ATOM:g}) rel_force_rmse={rel_f:.3e} "
          f"(tol {HALO_FORCE_RMSE_TOL:g})")
    if not (de_atom <= HALO_ENERGY_TOL_PER_ATOM
            and rel_f <= HALO_FORCE_RMSE_TOL):
        raise RuntimeError("(e) halo route disagrees with one card")
    return de_atom, rel_f


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card halo + distributed-PME "
                         "phase")
    args = ap.parse_args(argv)

    dev = phase_device()
    cards = bench.card_info()
    for line in cards:
        print(line)
    card = cards[0]
    from chargeflux_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache(2.0)}")

    if args.four:
        devices = jax.devices()
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, JAX found "
                               f"{len(devices)}")
        x, system = four_card_system()
        phase_four(x, system, devices[:4], card)
    else:
        x, system, masses, force = bench.build_full("30k")
        res = phase_main("b", x, system, masses, force, card)
        phase_correctness("c", res.positions, res.system, force,
                          ("pme", "xla"))
        x, system, masses, force = bench.build_full("216")
        res = phase_main("d", x, system, masses, force, card)
        phase_correctness("d", res.positions, res.system, force, ("xla",))

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
