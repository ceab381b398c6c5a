"""Geometry-dependent effective charges q(x) and their analytic Jacobian.

This is the JAX replacement for the reference's charge-flux update —
``updateRealCharge`` (ReferenceCoulKernels.cpp:37-228) and the CUDA
``calcRealCharge`` kernel (calcChargeFlux.cu:29-289).

Design (SURVEY §3.5): q(x) is a *pure function*; the total-force chain rule
``F -= dE/dq · dq/dx`` (ReferenceCoulKernels.cpp:493-499, README.md:57-65)
falls out of ``jax.grad(E ∘ q)`` automatically, so the engine needs no
explicit dedq/dqdx machinery.  The analytic COO Jacobian is nevertheless
implemented (:func:`charge_jacobian`) with the reference's exact formulas and
layout, both as a parity artifact (validated against ``jax.jacfwd`` in
tests/test_charges.py) and to drive the manual dedq force path used for
bit-level cross-checking (energy.py).

Scatter adds use ``x.at[idx].add`` — deterministic under XLA, replacing the
reference's CUDA atomics (calcChargeFlux.cu:70-94).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .pairs import displacement
from .system import ChargeFluxSystem


def _bond_geometry(positions, system: ChargeFluxSystem):
    """Min-image bond vectors p1 -> p2 and lengths. [B, 3], [B]."""
    idx = system.bond_idx
    d = displacement(positions[idx[:, 0]], positions[idx[:, 1]], system.box,
                     system.spec.pbc)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    return d, r


def _angle_geometry(positions, system: ChargeFluxSystem):
    """Law-of-cosines angle via three *independent* min-image deltas, matching
    the reference exactly (ReferenceCoulKernels.cpp:93-109 computes d21, d23
    and d13 each with their own minimum image)."""
    idx = system.angle_idx
    p1, p2, p3 = positions[idx[:, 0]], positions[idx[:, 1]], positions[idx[:, 2]]
    box, pbc = system.box, system.spec.pbc
    d21 = displacement(p2, p1, box, pbc)
    d23 = displacement(p2, p3, box, pbc)
    d13 = displacement(p1, p3, box, pbc)
    r21_2 = jnp.sum(d21 * d21, axis=-1)
    r23_2 = jnp.sum(d23 * d23, axis=-1)
    r13_2 = jnp.sum(d13 * d13, axis=-1)
    r21 = jnp.sqrt(r21_2)
    r23 = jnp.sqrt(r23_2)
    cost = (r23_2 + r21_2 - r13_2) / (2.0 * r21 * r23)
    # The reference takes acos unclamped (ReferenceCoulKernels.cpp:109-110);
    # we clamp for NaN-safety at collinear geometries (SURVEY §7 hard parts).
    cost = jnp.clip(cost, -1.0, 1.0)
    theta = jnp.arccos(cost)
    return d21, d23, r21, r23, cost, theta


def _water_geometry(positions, system: ChargeFluxSystem):
    idx = system.water_idx
    p1, p2, p3 = positions[idx[:, 0]], positions[idx[:, 1]], positions[idx[:, 2]]
    box, pbc = system.box, system.spec.pbc
    d12 = displacement(p1, p2, box, pbc)
    d13 = displacement(p1, p3, box, pbc)
    d23 = displacement(p2, p3, box, pbc)
    r12 = jnp.sqrt(jnp.sum(d12 * d12, axis=-1))
    r13 = jnp.sqrt(jnp.sum(d13 * d13, axis=-1))
    r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
    return d12, d13, d23, r12, r13, r23


def _template_dq_flat(positions: jax.Array, system: ChargeFluxSystem,
                      tpl, starts) -> jax.Array:
    """Charge deltas for ONE template block, flattened to [count*stride].

    Atom data reshapes to [C, s, 3]; every term indexes molecule slots with
    *static* slices, so neither the forward nor the autodiff backward emits
    a gather/scatter.  ``starts`` holds the per-kind row cursor into the
    molecule-major-permuted term arrays and is advanced in place.  Same
    formulas as the general path below — cross-checked in
    tests/test_charges.py.
    """
    dtype = positions.dtype
    box, pbc = system.box, system.spec.pbc
    off, s, c = tpl.offset, tpl.stride, tpl.count
    pos_m = positions[off:off + c * s].reshape(c, s, 3)
    p = [pos_m[:, l] for l in range(s)]           # static per-slot [C, 3]
    slot_dq = [[] for _ in range(s)]

    bond_rows = tpl.local_rows("bonds")
    if bond_rows:
        m = len(bond_rows)
        b0_ = starts["bonds"]
        starts["bonds"] += c * m
        k = system.bond_k[b0_:b0_ + c * m].reshape(c, m)
        b = system.bond_b[b0_:b0_ + c * m].reshape(c, m)
        for t, (l1, l2) in enumerate(bond_rows):
            d = displacement(p[l1], p[l2], box, pbc)
            r = jnp.sqrt(jnp.sum(d * d, axis=-1))
            dq = k[:, t] * (r - b[:, t])
            slot_dq[l1].append(dq)
            slot_dq[l2].append(-dq)

    angle_rows = tpl.local_rows("angles")
    if angle_rows:
        m = len(angle_rows)
        a0_ = starts["angles"]
        starts["angles"] += c * m
        k = system.angle_k[a0_:a0_ + c * m].reshape(c, m)
        t0 = system.angle_theta0[a0_:a0_ + c * m].reshape(c, m)
        for t, (l1, l2, l3) in enumerate(angle_rows):
            d21 = displacement(p[l2], p[l1], box, pbc)
            d23 = displacement(p[l2], p[l3], box, pbc)
            d13 = displacement(p[l1], p[l3], box, pbc)
            r21 = jnp.sqrt(jnp.sum(d21 * d21, axis=-1))
            r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
            r13_2 = jnp.sum(d13 * d13, axis=-1)
            cost = (r23 * r23 + r21 * r21 - r13_2) / (2.0 * r21 * r23)
            theta = jnp.arccos(jnp.clip(cost, -1.0, 1.0))
            dq = k[:, t] * (theta - t0[:, t])
            slot_dq[l1].append(dq)
            slot_dq[l3].append(dq)
            slot_dq[l2].append(-2.0 * dq)

    water_rows = tpl.local_rows("waters")
    if water_rows:
        m = len(water_rows)
        w0_ = starts["waters"]
        starts["waters"] += c * m
        sl = slice(w0_, w0_ + c * m)
        k1 = system.water_k1[sl].reshape(c, m)
        k2 = system.water_k2[sl].reshape(c, m)
        kub = system.water_kub[sl].reshape(c, m)
        b0 = system.water_b0[sl].reshape(c, m)
        ub0 = system.water_ub0[sl].reshape(c, m)
        for t, (lo, lh1, lh2) in enumerate(water_rows):
            d12 = displacement(p[lo], p[lh1], box, pbc)
            d13 = displacement(p[lo], p[lh2], box, pbc)
            d23 = displacement(p[lh1], p[lh2], box, pbc)
            r12 = jnp.sqrt(jnp.sum(d12 * d12, axis=-1))
            r13 = jnp.sqrt(jnp.sum(d13 * d13, axis=-1))
            r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
            dq2 = k1[:, t] * (r12 - b0[:, t]) + k2[:, t] * (r13 - b0[:, t]) \
                + kub[:, t] * (r23 - ub0[:, t])
            dq3 = k1[:, t] * (r13 - b0[:, t]) + k2[:, t] * (r12 - b0[:, t]) \
                + kub[:, t] * (r23 - ub0[:, t])
            slot_dq[lo].append(-dq2 - dq3)
            slot_dq[lh1].append(dq2)
            slot_dq[lh2].append(dq3)

    zero = jnp.zeros((c,), dtype)
    dq_slots = jnp.stack(
        [sum(sl[1:], sl[0]) if sl else zero for sl in slot_dq], axis=1)
    return dq_slots.reshape(-1)


def _scatter_flux(q: jax.Array, positions: jax.Array,
                  system: ChargeFluxSystem,
                  b0: int = 0, a0: int = 0, w0: int = 0) -> jax.Array:
    """General scatter-path charge update on term rows [b0:], [a0:], [w0:].

    With a TemplateSet this runs only on the remainder tail (the solute);
    without one it covers every row.  All kinds share ONE position gather
    and ONE ``at[].add`` scatter (deterministic under XLA, replacing the
    reference's charge atomics, calcChargeFlux.cu:70-94): gathers,
    scatters and reductions each break XLA fusion into separate kernels,
    so per-kind chains would pay one kernel boundary per kind."""
    box, pbc = system.box, system.spec.pbc

    bi = system.bond_idx[b0:]
    ai = system.angle_idx[a0:]
    wi = system.water_idx[w0:]
    n_b, n_a, n_w = bi.shape[0], ai.shape[0], wi.shape[0]
    if n_b + n_a + n_w == 0:
        return q
    idx_all = jnp.concatenate(
        [bi.reshape(-1), ai.reshape(-1), wi.reshape(-1)])
    p_all = positions[idx_all]                       # ONE gather [R, 3]
    dq_parts = []

    if n_b:
        # dq = k (r - b); q_p1 += dq, q_p2 -= dq
        # (ReferenceCoulKernels.cpp:60-62, calcChargeFlux.cu:68-75)
        pb = p_all[:2 * n_b].reshape(n_b, 2, 3)
        d = displacement(pb[:, 0], pb[:, 1], box, pbc)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        dq = system.bond_k[b0:] * (r - system.bond_b[b0:])
        dq_parts.append(jnp.stack([dq, -dq], axis=1).reshape(-1))

    if n_a:
        # dq = k (theta - theta0); q_p1 += dq, q_p3 += dq, q_p2 -= 2 dq
        # (ReferenceCoulKernels.cpp:112-115, calcChargeFlux.cu:133-142)
        pa = p_all[2 * n_b:2 * n_b + 3 * n_a].reshape(n_a, 3, 3)
        p1, p2, p3 = pa[:, 0], pa[:, 1], pa[:, 2]
        d21 = displacement(p2, p1, box, pbc)
        d23 = displacement(p2, p3, box, pbc)
        d13 = displacement(p1, p3, box, pbc)
        r21 = jnp.sqrt(jnp.sum(d21 * d21, axis=-1))
        r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
        r13_2 = jnp.sum(d13 * d13, axis=-1)
        cost = (r23 * r23 + r21 * r21 - r13_2) / (2.0 * r21 * r23)
        theta = jnp.arccos(jnp.clip(cost, -1.0, 1.0))
        dq = system.angle_k[a0:] * (theta - system.angle_theta0[a0:])
        dq_parts.append(jnp.stack([dq, -2.0 * dq, dq], axis=1).reshape(-1))

    if n_w:
        # CFF 3-site water (ReferenceCoulKernels.cpp:188-193,
        # calcChargeFlux.cu:228-239): sites (O, H1, H2) = (p1, p2, p3).
        pw = p_all[2 * n_b + 3 * n_a:].reshape(n_w, 3, 3)
        p1, p2, p3 = pw[:, 0], pw[:, 1], pw[:, 2]
        d12 = displacement(p1, p2, box, pbc)
        d13 = displacement(p1, p3, box, pbc)
        d23 = displacement(p2, p3, box, pbc)
        r12 = jnp.sqrt(jnp.sum(d12 * d12, axis=-1))
        r13 = jnp.sqrt(jnp.sum(d13 * d13, axis=-1))
        r23 = jnp.sqrt(jnp.sum(d23 * d23, axis=-1))
        k1, k2 = system.water_k1[w0:], system.water_k2[w0:]
        kub = system.water_kub[w0:]
        b0_, ub0 = system.water_b0[w0:], system.water_ub0[w0:]
        dq2 = k1 * (r12 - b0_) + k2 * (r13 - b0_) + kub * (r23 - ub0)
        dq3 = k1 * (r13 - b0_) + k2 * (r12 - b0_) + kub * (r23 - ub0)
        dq_parts.append(jnp.stack([-dq2 - dq3, dq2, dq3],
                                  axis=1).reshape(-1))

    return q.at[idx_all].add(jnp.concatenate(dq_parts))  # ONE scatter


@jax.jit
def effective_charges(positions: jax.Array, system: ChargeFluxSystem) -> jax.Array:
    """q_i = q0_i + sum of flux-bond/angle/water contributions. [N].

    Total charge is conserved by construction in every term (each term's
    deltas sum to zero), as in the reference (SURVEY §0.1).

    With a detected TemplateSet each repeated block takes the static-slice
    path (:func:`_template_dq_flat`; the blocks are non-overlapping and
    offset-sorted, so q assembles as one concatenation) and only the
    remainder rows — the solute in a solvated system — pay the scatter
    path (:func:`_scatter_flux`).
    """
    dtype = positions.dtype
    q = system.q0.astype(dtype)
    ts = system.spec.flux_template
    if ts is None:
        return _scatter_flux(q, positions, system)

    starts = {"bonds": 0, "angles": 0, "waters": 0}
    pieces = []
    cursor = 0
    for tpl in ts.templates:
        off, end = tpl.offset, tpl.offset + tpl.count * tpl.stride
        dq = _template_dq_flat(positions, system, tpl, starts)
        pieces.append(q[cursor:off])
        pieces.append(q[off:end] + dq)
        cursor = end
    pieces.append(q[cursor:])
    q = jnp.concatenate(pieces) if len(pieces) > 1 else pieces[0]
    return _scatter_flux(q, positions, system, b0=starts["bonds"],
                         a0=starts["angles"], w0=starts["waters"])


# ---------------------------------------------------------------------------
# Analytic sparse Jacobian dq/dx — parity artifact
# ---------------------------------------------------------------------------


def jacobian_index_layout(system: ChargeFluxSystem):
    """COO index arrays (dq_idx, dx_idx) in the reference's exact layout:
    4 entries per bond, then 9 per angle, then 9 per water
    (ReferenceCoulKernels.cpp:286-383).  Returns two int32 arrays [P]."""
    dq_rows = []
    dx_rows = []
    bi = system.bond_idx
    for order in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        dq_rows.append(bi[:, order[0]])
        dx_rows.append(bi[:, order[1]])
    bond_dq = jnp.stack(dq_rows, axis=1).reshape(-1) if bi.shape[0] else jnp.zeros(0, jnp.int32)
    bond_dx = jnp.stack(dx_rows, axis=1).reshape(-1) if bi.shape[0] else jnp.zeros(0, jnp.int32)

    def nine(idx):
        if idx.shape[0] == 0:
            z = jnp.zeros(0, jnp.int32)
            return z, z
        dq = jnp.stack([idx[:, a] for a in (0, 0, 0, 1, 1, 1, 2, 2, 2)], axis=1).reshape(-1)
        dx = jnp.stack([idx[:, b] for b in (0, 1, 2, 0, 1, 2, 0, 1, 2)], axis=1).reshape(-1)
        return dq, dx

    ang_dq, ang_dx = nine(system.angle_idx)
    wat_dq, wat_dx = nine(system.water_idx)
    return (jnp.concatenate([bond_dq, ang_dq, wat_dq]),
            jnp.concatenate([bond_dx, ang_dx, wat_dx]))


@jax.jit
def charge_jacobian_values(positions: jax.Array, system: ChargeFluxSystem) -> jax.Array:
    """Analytic dq/dx COO values [P, 3] in the reference layout.

    Value formulas: bonds ReferenceCoulKernels.cpp:64-79, angles :117-161,
    waters :194-226.  Entry p means d q[dq_idx[p]] / d x[dx_idx[p]].
    """
    dtype = positions.dtype
    chunks = []

    if system.bond_idx.shape[0] > 0:
        d, r = _bond_geometry(positions, system)
        val = (system.bond_k / r)[:, None] * d          # [B, 3]
        # order: (p1,p1)=-v, (p1,p2)=+v, (p2,p1)=+v, (p2,p2)=-v
        chunks.append(jnp.stack([-val, val, val, -val], axis=1).reshape(-1, 3))

    if system.angle_idx.shape[0] > 0:
        d21, d23, r21, r23, cost, _ = _angle_geometry(positions, system)
        k = system.angle_k
        one_r21r23 = 1.0 / (r21 * r23)
        one_const = 1.0 / jnp.sqrt(jnp.maximum(1.0 - cost * cost, 1e-300 if dtype == jnp.float64 else 1e-30))
        c1 = (k * one_r21r23 * one_const)[:, None]
        c2_21 = (k * cost * one_const / (r21 * r21))[:, None]
        c2_23 = (k * cost * one_const / (r23 * r23))[:, None]
        v1 = -c1 * d23 + c2_21 * d21
        v3 = -c1 * d21 + c2_23 * d23
        v2 = -v1 - v3
        # order (dq,dx): (1,1)(1,2)(1,3)(2,1)(2,2)(2,3)(3,1)(3,2)(3,3)
        chunks.append(jnp.stack(
            [v1, v2, v3, -2 * v1, -2 * v2, -2 * v3, v1, v2, v3], axis=1
        ).reshape(-1, 3))

    if system.water_idx.shape[0] > 0:
        d12, d13, d23, r12, r13, r23 = _water_geometry(positions, system)
        n12 = d12 / r12[:, None]
        n13 = d13 / r13[:, None]
        n23 = d23 / r23[:, None]
        k1 = system.water_k1[:, None]
        k2 = system.water_k2[:, None]
        ub = system.water_kub[:, None] * n23
        a12k1, a12k2 = k1 * n12, k2 * n12
        a13k1, a13k2 = k1 * n13, k2 * n13
        rows = [
            a12k1 + a12k2 + a13k1 + a13k2,      # (O, O)
            -a12k1 - a12k2 + 2 * ub,            # (O, H1)
            -a13k2 - a13k1 - 2 * ub,            # (O, H2)
            -a12k1 - a13k2,                     # (H1, O)
            a12k1 - ub,                         # (H1, H1)
            a13k2 + ub,                         # (H1, H2)
            -a12k2 - a13k1,                     # (H2, O)
            a12k2 - ub,                         # (H2, H1)
            a13k1 + ub,                         # (H2, H2)
        ]
        chunks.append(jnp.stack(rows, axis=1).reshape(-1, 3))

    if not chunks:
        return jnp.zeros((0, 3), dtype=dtype)
    return jnp.concatenate(chunks, axis=0)


def apply_chain_rule(dedq: jax.Array, positions: jax.Array,
                     system: ChargeFluxSystem) -> jax.Array:
    """Force contribution F[x_j] -= dedq[q_i] * dqdx[i, j] using the analytic
    COO Jacobian (the reference's multdQdX, calcChargeFlux.cu:291-313 /
    ReferenceCoulKernels.cpp:493-499).  Returns the force delta [N, 3]."""
    dq_idx, dx_idx = jacobian_index_layout(system)
    vals = charge_jacobian_values(positions, system)
    if vals.shape[0] == 0:
        return jnp.zeros_like(positions)
    contrib = -dedq[dq_idx][:, None] * vals
    return jnp.zeros_like(positions).at[dx_idx].add(contrib)
