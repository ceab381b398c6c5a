"""Benchmark harness: MD step time on one NVIDIA GPU for a ladder of boxes.

Prints ONE JSON line with the headline metric (ms per velocity-Verlet NVE
step — energy+forces+integration — at the 30k-atom Ewald box), plus ns/day
at the benchmark timestep and a per-phase breakdown.  Every result names
the device it ran on and the card's name and power limit (nvidia-smi).  A
run that finds no GPU fails: a CPU time is not a measurement of the card.

Usage: python bench.py [216|4k|30k|tri30k|hetero30k|100k|replicas|respa|rigid|npt]
(tri30k = the 30k box on a sheared reduced-triclinic lattice)

Methodology: run K MD steps on the device in one lax.scan (each step
consumes the previous forces, so steps cannot collapse), end each window
in a host sync (a scalar fetch), and difference two window lengths so the
fixed per-call cost (dispatch, the result's copy to the host) cancels.
Compilation is done ahead of the timed windows and reported apart.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

DT_PS = 5e-4   # 0.5 fs — flexible water needs a short step


def require_gpu():
    """The first JAX device, which must be a GPU.  Any other platform
    raises: a number taken there is not a measurement of the card, so
    there is no fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU, but JAX found platform "
            f"{dev.platform!r} ({dev.device_kind})")
    return dev


def card_info() -> list:
    """``name, power.limit`` of each card, as nvidia-smi reports them.
    Read in a child process that never imports JAX, so it holds no
    device memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_fields() -> dict:
    """The device fields every printed result carries."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()[0]}


def build_full(config: str, cutoff: float = None):
    from chargeflux_tpu.models import water_box

    # tri30k: the 30k box on a sheared (reduced triclinic) lattice — same
    # cell+PME production route, fractional binning + lattice-row image
    # offsets (cells.py); measures the triclinic overhead vs plain 30k
    tri = config.startswith("tri")
    base = config[3:] if tri else config
    n_side = {"216": 6, "4k": 11, "30k": 22, "100k": 32}.get(base)
    if n_side is None:
        raise SystemExit(f"unknown config {config!r}")
    # 216 stays dense (box too small for >=3 cells/axis); every larger
    # config uses the cell+PME route
    method = "dense" if base == "216" else "cell"
    # Model cutoff for the cell+PME configs: rc 0.8 nm (Ewald accuracy is
    # pinned by the tolerance at any rc, and rc is a user model knob in the
    # reference too — its default is 1.0, CoulForce.cpp:12-16).  With
    # Ewald the cutoff is a splitting knob: the 30k box takes rc 0.72 on
    # a forced 8^3 grid, the same walk program (slots, capacity) as rc 0.8
    # with triple the Verlet skin (0.06 -> 0.134 nm), so rebuilds come
    # about twice as rarely.  The forced grid awaits an A/B on the card.
    grid_kw = {}
    if cutoff is None:
        if base == "30k":
            cutoff, grid_kw = 0.72, {"cell_grid": (8, 8, 8)}
        else:
            cutoff = 0.8 if method == "cell" else 0.9
    force, pos, masses, box = water_box(n_side=n_side, flux="bond_angle",
                                        cutoff=cutoff)
    if tri:
        L = np.asarray(box, np.float64)
        box = np.array([[L[0], 0.0, 0.0],
                        [0.15 * L[0], L[1], 0.0],
                        [0.10 * L[0], -0.12 * L[1], L[2]]])
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method=method, **grid_kw)
    if method == "cell":
        # lattice initial configs alias against the cell grid and can beat
        # the 4-sigma default capacity; size it from the real occupancy
        from chargeflux_tpu.cells import suggest_capacity
        # margin 1.05: short near-equilibrium runs; the in-jit overflow
        # guard NaNs (and the final assert fails) if it's ever beaten
        cap = suggest_capacity(pos, box, system.spec.cell_grid, margin=1.05)
        if cap != system.spec.cell_capacity:
            system = force.create_system(box=box, dtype=jnp.float32,
                                         direct_method=method,
                                         cell_capacity=cap, **grid_kw)
    return (jnp.asarray(pos, jnp.float32), system,
            jnp.asarray(np.asarray(masses), jnp.float32), force)


def _timed_scan(run, x0, k1, k2, reps=7, warm_s=10.0):
    """ms per scan step of ``run(x0, k)`` (a k-step scan returning a
    scalar): the median over ``reps`` of paired (k2 - k1)-step window
    differences, each window ending in a host sync (the scalar fetch).
    Calls before the timed ones warm up (and compile, if ``run`` is a
    plain jitted function)."""
    # warm the card to steady state: clocks settle under *sustained* load
    # over seconds of stepping, not after a fixed dispatch count
    float(run(x0, k1))
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        float(run(x0, k2))

    def t(k):
        t0 = time.perf_counter()
        float(run(x0, k))
        return time.perf_counter() - t0

    # per-rep paired (k1, k2) differences: slow drift (clocks, heat)
    # cancels within a pair instead of biasing block-wise medians
    diffs = []
    for _ in range(reps):
        diffs.append(t(k2) - t(k1))
    return float(np.median(diffs)) / (k2 - k1) * 1e3


def _with_capacity(force, system, cap):
    # Forward every trace-time override from the existing spec: dropping
    # cell_grid would silently revert the forced 8^3 splitting-knob grid
    # to the derived 9^3 on every capacity re-provision, and the bench
    # would measure another program than the config it reports.
    spec = system.spec
    kw = {}
    if spec.cell_grid is not None:
        kw["cell_grid"] = spec.cell_grid
    if spec.pme_grid is not None and spec.recip_method in ("auto", "pme"):
        kw["pme_grid"] = spec.pme_grid
    return force.create_system(
        box=np.asarray(jax.device_get(system.box)), dtype=jnp.float32,
        direct_method="cell", cell_capacity=cap,
        recip_method=spec.recip_method, walk_layout=spec.walk_layout, **kw)


class MDStepResult(NamedTuple):
    """What :func:`measure_md_step` measured."""
    ms_per_step: float
    # last total energy of the longest timed window; NaN when any energy
    # in that window (or the final state) is not finite
    energy: float
    # the system timed: its cell capacity may be re-provisioned
    system: object
    positions: jax.Array     # [N, 3] at the end of that window
    compile_s: float         # compiling the timed program, both lengths
    memory: object           # memory_analysis() of the longer program
    rebuild_every: int


def _time_windows(run, p, k1, k2, steps_per_k):
    """Compile ``run`` (a jitted ``run(p, k)``, k static) for both window
    lengths, time it, and run the longer window once more as the check."""
    t0 = time.perf_counter()
    compiled = {k: run.lower(p, k).compile() for k in (k1, k2)}
    compile_s = time.perf_counter() - t0
    ms = _timed_scan(lambda pp, k: compiled[k](pp)[0], p, k1, k2,
                     reps=7) / steps_per_k
    e, p_end = compiled[k2](p)
    positions = jnp.reshape(p_end, (-1, 9))[:, :3]
    return ms, float(e), positions, compile_s, compiled[k2].memory_analysis()


def measure_md_step(x, system, masses, force=None,
                    bonded=None) -> MDStepResult:
    """ms per NVE velocity-Verlet step with neighbor-state reuse.

    On the cell route, ``system`` may come back with a larger cell
    capacity than the input when ``force`` is given: capacity is
    re-provisioned from the *relaxed* state's measured occupancy (the
    lattice-derived margin underestimates equilibrium density
    fluctuations, and an overflow NaN-poisons the run).  ``bonded``
    overrides the all-water bonded terms (heterogeneous legs).
    """
    from chargeflux_tpu.integrate import (init_state_nb,
                                          make_nb_energy_fn,
                                          make_packed_nve_chunk)
    from chargeflux_tpu.models import water_bonded_params
    from chargeflux_tpu.neighbors import suggest_rebuild_interval

    if bonded is None:
        bonded = water_bonded_params(system.n_atoms // 3, box=np.asarray(
            jnp.asarray(system.box)), dtype=jnp.float32)

    def bind(sys_):
        e_fn, init_nb = make_nb_energy_fn(sys_, bonded=bonded)

        def make_run(rebuild_every):
            # packed [N, 9] x|v|f carry (integrate.make_packed_nve_chunk)
            pack, _unpack, outer = make_packed_nve_chunk(
                e_fn, init_nb, masses, DT_PS, rebuild_every)

            @partial(jax.jit, static_argnums=(1,))
            def run(p, k):
                p_k, es = jax.lax.scan(outer, p, None, length=k)
                # any non-finite energy in the window (guard poison or
                # physics) or in the final state reaches the scalar
                e = jnp.where(jnp.all(jnp.isfinite(es)), es[-1, -1], jnp.nan)
                return e + 0.0 * jnp.sum(p_k), p_k
            return pack, run
        return e_fn, init_nb, make_run

    if system.spec.direct_method != "cell":
        e_fn, init_nb, make_run = bind(system)
        s0 = init_state_nb(x, jnp.zeros_like(x), e_fn, init_nb)
        pack, run = make_run(10)
        ms, e, pos, compile_s, mem = _time_windows(run, pack(s0), 1, 6, 10)
        return MDStepResult(ms, e, system, pos, compile_s, mem, 10)

    # --- burn in the lattice-relaxation transient before timing ---
    # The jittered-lattice start relaxes violently from rest (max |v|
    # ~13.5 nm/ps within ~10 steps at 30k, ~80 MJ/mol potential drop);
    # timing that transient with a thermal-bound rebuild interval
    # trips the freshness guard, and its density fluctuations can beat a
    # lattice-derived cell capacity.  Burn ~240 steps on a generously
    # provisioned twin (capacity margin 1.35, 24 nm/ps rebuild bound),
    # rescaling velocities to 300 K at every chunk boundary (host-side
    # Berendsen-style quench — setup only); then provision the production
    # system from the *measured* relaxed occupancy and pick its rebuild
    # interval from the *measured* post-burn max speed.
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.utils import max_cell_occupancy

    kB = 0.00831446261815324  # kJ/mol/K
    n_dof = 3.0 * system.n_atoms
    m_np = np.asarray(masses, np.float64)

    burn_sys = system
    if force is not None:
        cap_burn = suggest_capacity(
            np.asarray(x), np.asarray(jax.device_get(system.box)),
            system.spec.cell_grid, margin=1.35)
        if cap_burn > system.spec.cell_capacity:
            burn_sys = _with_capacity(force, system, cap_burn)
    e_fn_b, init_nb_b, make_run_b = bind(burn_sys)
    s0 = init_state_nb(x, jnp.zeros_like(x), e_fn_b, init_nb_b)
    re_burn = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0,
                                       cap=40)
    pack_b, run_b = make_run_b(re_burn)
    p = pack_b(s0)
    occ_hist = []
    for _ in range(max(1, int(np.ceil(240 / re_burn)))):
        e_last, p = run_b(p, 1)
        assert np.isfinite(float(e_last)), "burn-in chunk NaN-poisoned"
        # view the carry as [N, 9] for the host-side quench regardless of
        # the packed-carry representation (integrate.PACKED_CARRY_MODE)
        p_shape = np.shape(p)
        p = np.array(p).reshape(-1, 9)
        v = p[:, 3:6].astype(np.float64)
        t_cur = float(np.sum(m_np[:, None] * v * v)) / (n_dof * kB)
        p[:, 3:6] = (v * math.sqrt(300.0 / max(t_cur, 1.0))).astype(
            p.dtype)
        occ_hist.append(max_cell_occupancy(p[:, :3], system))
        p = jnp.asarray(p.reshape(p_shape))

    # production capacity: 1.05 over the relaxed-half peak occupancy
    # (rounded to 8), never below the lattice-derived value; the in-jit
    # NaN guard stays as the backstop for the remaining tail risk
    occ_eq = max(occ_hist[len(occ_hist) // 2:])
    cap_eq = -(-int(math.ceil(occ_eq * 1.05)) // 8) * 8
    if force is not None and cap_eq > system.spec.cell_capacity:
        system = _with_capacity(force, system, cap_eq)

    p9 = jnp.reshape(p, (-1, 9))
    xr, vr = p9[:, :3], p9[:, 3:6]
    e_fn, init_nb, make_run = bind(system)
    s1 = init_state_nb(jnp.asarray(xr), jnp.asarray(vr), e_fn, init_nb)
    vmax = float(np.max(np.linalg.norm(np.asarray(vr), axis=-1)))
    # 1.2x margin over the observed max speed: displacement over a window
    # runs well below the ballistic bound (the fastest atom oscillates),
    # and the full-window NaN check below is the backstop
    rebuild_every = suggest_rebuild_interval(
        system, DT_PS, max_speed=max(8.0, 1.2 * vmax), cap=40)
    print(f"# measure_md_step: rebuild_every={rebuild_every} "
          f"vmax={vmax:.2f} cap={system.spec.cell_capacity}",
          file=sys.stderr)
    pack, run = make_run(rebuild_every)

    k1 = max(1, 10 // rebuild_every)
    # the NaN check covers the FULL longest timed window (a poison in a
    # later chunk must fail the bench, not just one in chunk 1)
    ms, e, pos, compile_s, mem = _time_windows(run, pack(s1), k1, 6 * k1,
                                               rebuild_every)
    return MDStepResult(ms, e, system, pos, compile_s, mem, rebuild_every)


def measure_phases(x, system):
    """Per-phase fwd+grad timings for the breakdown field.

    ``direct``/``recip`` are *in-context marginal* costs: t(base+phase) -
    t(base), with the binning frozen outside the step (matching how the MD
    loop amortizes it).  Composites measured this way are additive (the
    sum matches the full step); per-phase scan loops that only vary one
    input under-measure because XLA hoists the invariant work.
    """
    from chargeflux_tpu import cells
    from chargeflux_tpu.charges import effective_charges
    from chargeflux_tpu.energy import _energy, _exclusion_correction
    from chargeflux_tpu.ewald import self_energy
    from chargeflux_tpu.neighbors import build_neighbor_state
    from chargeflux_tpu.pme import pme_cell_reciprocal_energy

    spec = system.spec
    out = {}
    if spec.direct_method != "cell":
        return out
    nb = build_neighbor_state(x, system)
    ids = nb.slots.reshape(spec.cell_grid + (spec.cell_capacity,))

    def grad_loop(f, k1=2, k2=52):
        @partial(jax.jit, static_argnums=(1,))
        def run(x0, k):
            def step(xx, _):
                e, g = jax.value_and_grad(f)(xx)
                return xx - 1e-12 * g, e
            xk, es = jax.lax.scan(step, x0, None, length=k)
            return es[-1] + 0.0 * jnp.sum(xk)

        return _timed_scan(run, x, k1, k2, reps=5)

    def make_e(with_walk, with_recip):
        def f(xx):
            q = effective_charges(xx, system)
            b = cells.blockify(xx, q, system, nb.slots, nb.inv_slot,
                               wrap=nb.wrap)
            e = (jnp.sum(b.x) * 1e-20 + self_energy(q, spec.alpha)
                 + _exclusion_correction(xx, q, system, True))
            if with_walk:
                e = e + cells.direct_energy_on_blocks(b, ids, system)
            if with_recip:
                e = e + pme_cell_reciprocal_energy(b, ids, system)
            return e
        return f

    t_base = grad_loop(make_e(False, False))
    out["base_charges_blockify_excl"] = round(t_base, 3)
    out["direct_in_context"] = round(grad_loop(make_e(True, False)) - t_base, 3)
    out["recip_in_context"] = round(grad_loop(make_e(False, True)) - t_base, 3)

    def binning(xx, _):
        slots, _i, ov = cells.build_cell_list_full(
            xx, system.box, spec.cell_grid, spec.cell_capacity)
        return xx + 0.0 * jnp.sum(slots % 7).astype(xx.dtype), \
            ov.astype(xx.dtype)

    @partial(jax.jit, static_argnums=(1,))
    def run_b(x0, k):
        xk, es = jax.lax.scan(binning, x0, None, length=k)
        return es[-1] + 0.0 * jnp.sum(xk)

    out["binning_standalone"] = round(_timed_scan(run_b, x, 2, 52, reps=5), 3)
    out["full_fwd_grad_incl_binning"] = round(grad_loop(
        lambda xx: _energy(xx, system)), 3)
    return out


def bench_respa(n_inner: int = 4):
    """NVT r-RESPA at the 30k box: ms per *outer* step (one nonbonded
    evaluation + n_inner bonded BAOAB substeps of 0.5 fs), i.e. ms per
    2 fs of simulated time.  Equilibrates on-device first (0.2 ps of
    plain 0.5 fs BAOAB from Maxwell velocities) — impulse MTS at 2 fs
    outer needs an equilibrated liquid (tests/test_respa.py); the final
    finite-energy assert would catch a blowup or an overflow poison."""
    from chargeflux_tpu.integrate import (
        init_state_nb, make_nb_energy_fn,
        make_packed_respa_langevin_chunk, make_respa_force_fns,
        maxwell_velocities)
    from chargeflux_tpu.models import water_bonded_params
    from chargeflux_tpu.neighbors import suggest_rebuild_interval

    x, system, masses, force = build_full("30k")
    dt_out = DT_PS * n_inner
    bonded = water_bonded_params(system.n_atoms // 3, box=np.asarray(
        jnp.asarray(system.box)), dtype=jnp.float32)

    # on-device burn-in at the plain 0.5 fs step, on a generously
    # provisioned twin (the lattice-derived capacity margin is too thin
    # for the relaxed liquid's density fluctuations and overflows at
    # 300 K); production capacity comes from the relaxed state
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.integrate import langevin_trajectory_nb
    from chargeflux_tpu.utils import max_cell_occupancy

    cap_burn = suggest_capacity(
        np.asarray(x), np.asarray(jax.device_get(system.box)),
        system.spec.cell_grid, margin=1.35)
    burn_sys = (_with_capacity(force, system, cap_burn)
                if cap_burn > system.spec.cell_capacity else system)
    e_fn, init_nb = make_nb_energy_fn(burn_sys, bonded=bonded)
    v0 = maxwell_velocities(masses, 300.0, jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    s0 = init_state_nb(x, v0, e_fn, init_nb)
    # 24 nm/ps bound: the lattice-relaxation transient reaches ~13.5 nm/ps
    # (measure_md_step's burn uses the same); under the default 8 nm/ps
    # bound atoms outrun skin/2 between rebuilds and the freshness guard
    # NaN-poisons this burn-in
    re_b = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0, cap=10)
    n_burn = -(-400 // re_b) * re_b   # round up to a rebuild multiple
    s_eq, kes0 = langevin_trajectory_nb(
        s0, e_fn, init_nb, masses, dt=DT_PS, temperature=300.0,
        friction=20.0, key=jax.random.PRNGKey(1), n_steps=n_burn,
        rebuild_every=re_b)
    assert np.all(np.isfinite(np.asarray(kes0))), "burn-in NaN"

    # 1.10 margin over a single relaxed occupancy sample (vs 1.05 over a
    # 30-sample max in measure_md_step); the in-jit NaN guard backstops
    occ_eq = max_cell_occupancy(s_eq.positions, system)
    cap_eq = -(-int(math.ceil(occ_eq * 1.10)) // 8) * 8
    if cap_eq > system.spec.cell_capacity:
        system = _with_capacity(force, system, cap_eq)

    slow_fn, fast_fn, init_nb2 = make_respa_force_fns(system, bonded)
    rebuild_every = suggest_rebuild_interval(system, dt_out, cap=40)
    init_carry, outer = make_packed_respa_langevin_chunk(
        slow_fn, fast_fn, init_nb2, masses, dt_out, n_inner,
        temperature=300.0, friction=5.0, rebuild_every=rebuild_every,
        dtype=jnp.float32)
    p0, _k = init_carry(s_eq, jax.random.PRNGKey(2))

    @partial(jax.jit, static_argnums=(1,))
    def run(p, k):
        (p_k, _kk), kes = jax.lax.scan(outer, (p, jax.random.PRNGKey(3)),
                                       None, length=k)
        return kes[-1, -1] + 0.0 * jnp.sum(p_k)

    k1 = max(1, 10 // rebuild_every)
    ms_chunk = _timed_scan(run, p0, k1, 6 * k1, reps=7)
    ms = ms_chunk / rebuild_every
    ke_check = float(run(p0, k1))
    ns_day = dt_out * 1e-3 * 86400.0 * 1000.0 / ms
    print(json.dumps({
        **device_fields(),
        "metric": "ms_per_respa_outer_step_30k_ewald_f32",
        "value": round(ms, 4),
        "unit": "ms",
        "ns_per_day": round(ns_day, 2),
        "dt_outer_fs": dt_out * 1e3,
        "n_inner": n_inner,
        "rebuild_every": rebuild_every,
        "cell_capacity": system.spec.cell_capacity,
        "cell_grid": list(system.spec.cell_grid) if system.spec.cell_grid else None,
    }))
    assert np.isfinite(ke_check), "RESPA benchmark trajectory produced NaN"


def bench_rigid():
    """Rigid-TIP3P 30k box at dt = 2 fs (RATTLE-constrained BAOAB with
    neighbor reuse) — the production rigid-solvent configuration OpenMM
    would run the reference in.  Rigid geometry makes the intramolecular
    flux constant, so this config has fixed charges; the metric is ms per
    2 fs step."""
    from chargeflux_tpu.constraints import rattle_langevin_trajectory_nb
    from chargeflux_tpu.integrate import (init_state_nb, make_nb_energy_fn,
                                          maxwell_velocities)
    from chargeflux_tpu.models import rigid_water_box
    from chargeflux_tpu.neighbors import suggest_rebuild_interval

    dt = 2e-3
    # rc 0.72 on the forced 8^3 grid: at dt 2 fs the rc 0.8 config's
    # 0.06 nm skin forces rebuild_every=1 (full binning EVERY step); the
    # splitting-knob config rebuilds every 4
    force, pos, masses, box, params = rigid_water_box(n_side=22, cutoff=0.72,
                                                      dtype=jnp.float32)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell", cell_grid=(8, 8, 8))
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.utils import max_cell_occupancy
    cap = suggest_capacity(pos, box, system.spec.cell_grid, margin=1.1)
    if cap != system.spec.cell_capacity:
        system = force.create_system(box=box, dtype=jnp.float32,
                                     direct_method="cell",
                                     cell_capacity=cap, cell_grid=(8, 8, 8))
    x = jnp.asarray(pos, jnp.float32)
    m = jnp.asarray(np.asarray(masses), jnp.float32)
    # burn on a generously provisioned twin; production capacity from the
    # relaxed state (lattice margins underestimate liquid fluctuations)
    cap_burn = suggest_capacity(pos, box, system.spec.cell_grid,
                                margin=1.35)
    burn_sys = (_with_capacity(force, system, cap_burn)
                if cap_burn > system.spec.cell_capacity else system)
    e_fn_b, init_nb_b = make_nb_energy_fn(burn_sys)
    # the lattice-start transient spikes H velocities to ~10 nm/ps
    # (measured): rebuild on a 12 nm/ps budget while hot, 8 in production
    # (the freshness guard NaN-poisons if either bound is ever beaten)
    rebuild_hot = suggest_rebuild_interval(burn_sys, dt, max_speed=12.0,
                                           cap=10)
    v0 = maxwell_velocities(m, 300.0, jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    s0 = init_state_nb(x, v0, e_fn_b, init_nb_b)
    # on-device burn-in: relax the lattice transient before timing
    s_eq, kes0 = rattle_langevin_trajectory_nb(
        s0, e_fn_b, init_nb_b, m, dt=dt, temperature=300.0, friction=20.0,
        key=jax.random.PRNGKey(1), n_steps=200 * rebuild_hot,
        rebuild_every=rebuild_hot, params=params)
    assert np.all(np.isfinite(np.asarray(kes0))), "rigid burn-in NaN"

    occ_eq = max_cell_occupancy(s_eq.positions, system)
    cap_eq = -(-int(math.ceil(occ_eq * 1.10)) // 8) * 8
    if cap_eq > system.spec.cell_capacity:
        system = _with_capacity(force, system, cap_eq)
    e_fn, init_nb = make_nb_energy_fn(system)
    # rebuild bound from the MEASURED relaxed max speed (rigid molecules
    # have no intramolecular vibration, so the fastest atom runs ~2x
    # slower than flexible water's — the flat 8 nm/ps bound forced
    # rebuild_every=1 at dt=2fs and binning dominated the r2 rigid bench)
    vmax = float(np.max(np.linalg.norm(
        np.asarray(jax.device_get(s_eq.velocities)), axis=-1)))
    rebuild_every = suggest_rebuild_interval(
        system, dt, max_speed=max(4.0, 1.2 * vmax), cap=40)
    s_eq = init_state_nb(s_eq.positions, s_eq.velocities, e_fn, init_nb)

    def chunk(k):
        s, kes = rattle_langevin_trajectory_nb(
            s_eq, e_fn, init_nb, m, dt=dt, temperature=300.0, friction=5.0,
            key=jax.random.PRNGKey(2), n_steps=k * rebuild_every,
            rebuild_every=rebuild_every, params=params)
        return kes[-1]

    @partial(jax.jit, static_argnums=(1,))
    def run(_p, k):
        return chunk(k)

    k1 = max(1, 10 // rebuild_every)
    ms_chunk = _timed_scan(run, 0, k1, 6 * k1, reps=7)
    ms = ms_chunk / rebuild_every
    ke_check = float(run(0, k1))
    ns_day = dt * 1e-3 * 86400.0 * 1000.0 / ms
    print(json.dumps({
        **device_fields(),
        "metric": "ms_per_rigid_md_step_30k_ewald_f32",
        "value": round(ms, 4),
        "unit": "ms",
        "ns_per_day": round(ns_day, 2),
        "dt_fs": dt * 1e3,
        "rebuild_every": rebuild_every,
        "atoms": system.n_atoms,
        "cell_capacity": system.spec.cell_capacity,
        "cell_grid": list(system.spec.cell_grid) if system.spec.cell_grid else None,
    }))
    assert np.isfinite(ke_check), "rigid benchmark trajectory produced NaN"


def bench_replicas(n_replicas: int = 64):
    """64-replica vmap ensemble on a 216-water box."""
    from chargeflux_tpu.energy import _energy
    from chargeflux_tpu.models import water_box

    force, pos, _, box = water_box(n_side=6, flux="bond_angle")
    system = force.create_system(box=box, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = jnp.asarray(np.stack(
        [pos + 0.01 * rng.standard_normal(pos.shape)
         for _ in range(n_replicas)]), jnp.float32)

    n = batch.shape[1]

    # flat [R, N*3] scan carry (a narrow minor-dim-3 carry awaits an A/B
    # on the card)
    def step(xb, _):
        def one(xf):
            xc = xf.reshape(n, 3)
            e, g = jax.value_and_grad(_energy)(xc, system)
            return (xc - 1e-9 * g).reshape(-1), e
        xb, es = jax.vmap(one)(xb)
        return xb, jnp.sum(es)

    @partial(jax.jit, static_argnums=(1,))
    def run(x0, k):
        xk, es = jax.lax.scan(step, x0, None, length=k)
        return es[-1] + 0.0 * jnp.sum(xk)

    ms = _timed_scan(run, batch.reshape(n_replicas, -1), 3, 13, reps=5)
    print(json.dumps({
        **device_fields(),
        "metric": f"ms_per_step_{n_replicas}x216_replica_ensemble",
        "value": round(ms, 4),
        "unit": "ms",
    }))


def bench_hetero():
    """30k solvated-chain box: a 300-bead bonded chain solute whose flux
    bonds/exclusions/bonded terms ride the scatter-REMAINDER path +
    ~10.5k templated flux waters."""
    from chargeflux_tpu.bonded import BondedParams
    from chargeflux_tpu.models import solvated_chain_box

    # rc 0.72 on the forced 8^3 grid: same splitting-knob config as the
    # 30k water leg (identical walk program, tripled Verlet skin)
    force, pos, masses, box, bonded_kw = solvated_chain_box(
        n_side=22, n_solute_sites=100, cutoff=0.72)
    system = force.create_system(box=box, dtype=jnp.float32,
                                 direct_method="cell", cell_grid=(8, 8, 8))
    ts = system.spec.flux_template
    assert ts is not None and dict(ts.remainder)["bonds"] == 299
    from chargeflux_tpu.cells import suggest_capacity
    cap = suggest_capacity(pos, box, system.spec.cell_grid, margin=1.05)
    if cap != system.spec.cell_capacity:
        system = force.create_system(box=box, dtype=jnp.float32,
                                     direct_method="cell",
                                     cell_capacity=cap, cell_grid=(8, 8, 8))
    bonded = BondedParams.create(box=box, pbc=True, dtype=jnp.float32,
                                 **bonded_kw)
    x = jnp.asarray(pos, jnp.float32)
    m = jnp.asarray(np.asarray(masses), jnp.float32)
    t0 = time.perf_counter()
    res = measure_md_step(x, system, m, force=force, bonded=bonded)
    wall_s = time.perf_counter() - t0
    ms, e_check, system = res.ms_per_step, res.energy, res.system
    print(json.dumps({
        **device_fields(),
        "metric": "ms_per_md_step_hetero30k_ewald_f32",
        "value": round(ms, 4),
        "unit": "ms",
        "ns_per_day": round(DT_PS * 1e-3 * 86400.0 * 1000.0 / ms, 2),
        "dt_fs": DT_PS * 1e3,
        "atoms": system.n_atoms,
        "solute_atoms": 300,
        "cell_capacity": system.spec.cell_capacity,
        "cell_grid": list(system.spec.cell_grid) if system.spec.cell_grid else None,
    }))
    print(f"# config=hetero30k wall={wall_s:.1f}s "
          f"compile={res.compile_s:.1f}s "
          f"energy={e_check:.3f}", file=sys.stderr)
    assert np.isfinite(e_check), "benchmark trajectory produced NaN"


def bench_npt():
    """NPT 30k: BAOAB Langevin + isotropic MC barostat at 300 K / 1 bar,
    dt 0.5 fs, one volume attempt per rebuild chunk — the constant-
    pressure production configuration.  The reference delegates NPT to
    its host framework (OpenMM MonteCarloBarostat); here the barostat's
    volume moves ride a traced box through the whole engine and the MD
    chunk runs on the packed [N, 9] carry.  Metric: ms per NPT
    MD step (amortized barostat attempt + re-bin included)."""
    from chargeflux_tpu.cells import suggest_capacity
    from chargeflux_tpu.integrate import (init_state_nb,
                                          langevin_trajectory_nb,
                                          make_nb_energy_fn)
    from chargeflux_tpu.models import water_bonded_params
    from chargeflux_tpu.neighbors import suggest_rebuild_interval
    from chargeflux_tpu.npt import npt_langevin_trajectory
    from chargeflux_tpu.utils import max_cell_occupancy

    x, system, masses, force = build_full("30k")
    bonded = water_bonded_params(
        system.n_atoms // 3,
        box=np.asarray(jax.device_get(system.box)), dtype=jnp.float32)
    m = jnp.asarray(np.asarray(masses), jnp.float32)

    # burn-in on a generously provisioned twin (same rationale as
    # measure_md_step), thermostatted at the production temperature
    cap_burn = suggest_capacity(
        np.asarray(x), np.asarray(jax.device_get(system.box)),
        system.spec.cell_grid, margin=1.35)
    burn_sys = (_with_capacity(force, system, cap_burn)
                if cap_burn > system.spec.cell_capacity else system)
    e_fn_b, init_nb_b = make_nb_energy_fn(burn_sys, bonded=bonded)
    re_burn = suggest_rebuild_interval(burn_sys, DT_PS, max_speed=24.0,
                                       cap=10)
    s0 = init_state_nb(x, jnp.zeros_like(x), e_fn_b, init_nb_b)
    n_burn = -(-400 // re_burn) * re_burn
    s_eq, kes = langevin_trajectory_nb(
        s0, e_fn_b, init_nb_b, m, dt=DT_PS, temperature=300.0,
        friction=20.0, key=jax.random.PRNGKey(1), n_steps=n_burn,
        rebuild_every=re_burn)
    assert np.all(np.isfinite(np.asarray(kes))), "NPT burn-in NaN"

    occ_eq = max_cell_occupancy(s_eq.positions, system)
    cap_eq = -(-int(math.ceil(occ_eq * 1.10)) // 8) * 8
    if cap_eq > system.spec.cell_capacity:
        system = _with_capacity(force, system, cap_eq)
    vmax = float(np.max(np.linalg.norm(
        np.asarray(jax.device_get(s_eq.velocities)), axis=-1)))
    interval = suggest_rebuild_interval(
        system, DT_PS, max_speed=max(8.0, 1.2 * vmax), cap=40)
    print(f"# bench_npt: barostat_interval={interval} vmax={vmax:.2f} "
          f"cap={system.spec.cell_capacity}", file=sys.stderr)

    x_eq = jnp.asarray(s_eq.positions)
    v_eq = jnp.asarray(s_eq.velocities)

    @partial(jax.jit, static_argnums=(1,))
    def run(_p, k):
        xf, vf, boxf, diag = npt_langevin_trajectory(
            x_eq, v_eq, system, m, dt=DT_PS, temperature=300.0,
            friction=5.0, pressure_bar=1.0, key=jax.random.PRNGKey(2),
            n_steps=k * interval, barostat_interval=interval,
            bonded=bonded)
        return diag["energies"][-1] + 0.0 * (jnp.sum(xf) + jnp.sum(boxf))

    k1 = max(1, 10 // interval)
    ms_chunk = _timed_scan(run, 0, k1, 6 * k1, reps=7)
    ms = ms_chunk / interval
    e_check = float(run(0, 6 * k1))
    print(json.dumps({
        **device_fields(),
        "metric": "ms_per_npt_md_step_30k_ewald_f32",
        "value": round(ms, 4),
        "unit": "ms",
        "ns_per_day": round(DT_PS * 1e-3 * 86400.0 * 1000.0 / ms, 2),
        "dt_fs": DT_PS * 1e3,
        "barostat_interval": interval,
        "atoms": system.n_atoms,
        "cell_capacity": system.spec.cell_capacity,
        "cell_grid": list(system.spec.cell_grid) if system.spec.cell_grid else None,
    }))
    assert np.isfinite(e_check), "NPT benchmark trajectory produced NaN"


def main():
    config = sys.argv[1] if len(sys.argv) > 1 else "30k"
    require_gpu()
    from chargeflux_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(2.0)
    if config == "npt":
        bench_npt()
        return
    if config == "hetero30k":
        bench_hetero()
        return
    if config == "replicas":
        bench_replicas()
        return
    if config == "respa":
        bench_respa()
        return
    if config == "rigid":
        bench_rigid()
        return
    x, system, masses, force = build_full(config)

    t0 = time.perf_counter()
    res = measure_md_step(x, system, masses, force=force)
    wall_s = time.perf_counter() - t0
    ms, e_check, system = res.ms_per_step, res.energy, res.system

    ns_day = DT_PS * 1e-3 * 86400.0 * 1000.0 / ms
    result = {
        **device_fields(),
        "metric": f"ms_per_md_step_{config}_ewald_f32",
        "value": round(ms, 4),
        "unit": "ms",
        "ns_per_day": round(ns_day, 2),
        "dt_fs": DT_PS * 1e3,
        "compile_s": round(res.compile_s, 1),
    }
    if config == "30k":
        result["phases_ms"] = measure_phases(x, system)
        result["model_cutoff_nm"] = system.spec.cutoff
        # reference-default model (cutoff 1.0 nm, CoulForce.cpp:12-16):
        # same tolerance, same physics contract as the reference's own
        # default configuration.  Side measurement only: its failure is
        # reported in the result and never sinks the headline metric.
        try:
            x10, sys10, m10, f10 = build_full(config, cutoff=1.0)
            res10 = measure_md_step(x10, sys10, m10, force=f10)
            assert np.isfinite(res10.energy)
            result["ms_per_md_step_rc10"] = round(res10.ms_per_step, 4)
            result["rc10_cell_capacity"] = res10.system.spec.cell_capacity
        except Exception as exc:
            result["rc10_error"] = f"{type(exc).__name__}: {exc}"[:120]
    print(json.dumps(result))
    print(f"# config={config} atoms={system.n_atoms} "
          f"wall={wall_s:.1f}s compile={res.compile_s:.1f}s "
          f"kmax={system.spec.kmax} pme={system.spec.pme_grid} "
          f"grid={system.spec.cell_grid} cap={system.spec.cell_capacity} "
          f"energy={e_check:.3f}", file=sys.stderr)
    assert np.isfinite(e_check), "benchmark trajectory produced NaN"


if __name__ == "__main__":
    main()
