"""Rigid 3-site (water) holonomic constraints — RATTLE position and
velocity projections, vectorized over the molecule template.

The reference plugin computes only forces; rigid-solvent constraints are
an L0 service of its host framework (OpenMM SETTLE/CCMA — SURVEY §1 L0),
so a standalone engine must ship them: rigid water is how production MD
buys the 2 fs whole-step the flexible models cannot take.

Design: rigid waters live in the contiguous ``[n_mol, 3, 3]``
template layout (topology.py) — static slices, no gathers.  The three
coupled bond constraints per molecule form a 3x3 Lagrange system solved
by Newton iteration with a closed-form (adjugate) 3x3 inverse: a fixed,
data-independent iteration count (quadratic convergence — 4 iterations
reach f64 machine epsilon from MD-size violations), so the whole
projection is straight-line vector code under jit, batched over
molecules.  Non-convergence is VISIBLE: a residual beyond tolerance
NaN-poisons the positions (house failure-detection style, like cell
overflow), never silently approximate.

The velocity projection is exact in one 3x3 solve (the constraint is
linear in the multipliers).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp


# bond k connects sites (I[k], J[k]); water sites ordered O, H1, H2
_BOND_I = (0, 0, 1)
_BOND_J = (1, 2, 2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidWaterParams:
    """Constraint metadata for ``count`` contiguous 3-site molecules
    starting at atom ``offset`` (site order O, H1, H2, matching the water
    model builders)."""

    targets2: jax.Array    # [3] squared bond lengths (OH1, OH2, HH), nm^2
    inv_m: jax.Array       # [3] 1/mass per site, 1/amu
    offset: int = dataclasses.field(metadata=dict(static=True))
    count: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, count: int, d_oh: float, d_hh: float,
               m_o: float, m_h: float, offset: int = 0,
               dtype=jnp.float64) -> "RigidWaterParams":
        return cls(
            targets2=jnp.asarray([d_oh * d_oh, d_oh * d_oh, d_hh * d_hh],
                                 dtype),
            inv_m=jnp.asarray([1.0 / m_o, 1.0 / m_h, 1.0 / m_h], dtype),
            offset=offset,
            count=count,
        )

    @property
    def n_constraints(self) -> int:
        return 3 * self.count


def _mol_view(x, params):
    """[N, 3] -> (head, [count, 3 sites, 3], tail) static split."""
    o, c = params.offset, params.count
    return x[:o], x[o:o + 3 * c].reshape(c, 3, 3), x[o + 3 * c:]


def _bond_vectors(xm):
    """[M, 3, 3] site positions -> [M, 3 bonds, 3] bond vectors."""
    return jnp.stack([xm[:, _BOND_I[k]] - xm[:, _BOND_J[k]]
                      for k in range(3)], axis=1)


def _incidence() -> np.ndarray:
    s = np.zeros((3, 3))   # incidence: s[k, site]
    for k in range(3):
        s[k, _BOND_I[k]] = 1.0
        s[k, _BOND_J[k]] = -1.0
    return s


_S = _incidence()


def _mass_coupling(inv_m):
    """w[k, l] = sum over sites of (incidence_k * incidence_l / m_site):
    the mass metric coupling bond k's constraint to bond l's impulse.
    Pure jnp (inv_m may be traced under jit)."""
    s = jnp.asarray(_S, inv_m.dtype)
    return jnp.matmul(s * inv_m[None, :], s.T,
                      precision=jax.lax.Precision.HIGHEST)


def _solve33(a, b):
    """Batched closed-form 3x3 solve via the adjugate (no LAPACK calls —
    straight vector arithmetic that fuses under jit).  a [M,3,3],
    b [M,3] -> [M,3]."""
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    c10 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c21 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    x0 = c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2]
    x1 = c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2]
    x2 = c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]
    return jnp.stack([x0, x1, x2], axis=1) / det[:, None]


def _displace(lam, d_ref, inv_m):
    """Site displacements from bond impulses: x_i += 2 lam_k d_ref_k / m_i
    with the bond incidence signs.  lam [M,3], d_ref [M,3,3] -> [M,3,3]."""
    dx = jnp.zeros_like(d_ref)
    for k in range(3):
        imp = 2.0 * lam[:, k, None] * d_ref[:, k]
        dx = dx.at[:, _BOND_I[k]].add(imp * inv_m[_BOND_I[k]])
        dx = dx.at[:, _BOND_J[k]].add(-imp * inv_m[_BOND_J[k]])
    return dx


# --- structure-of-arrays projection core ------------------------------------
# The projection math lives on [M]-shaped per-(site, coordinate) arrays:
# an [M, 3, 3] layout puts the (3, 3) minor dims on the device's tiled
# layout, where every elementwise op in the Newton loop pays the padding
# of that tile.  SoA [M] vectors tile densely; AoS<->SoA conversion
# happens once per projection (one transpose each way).


def _soa_view(x, params):
    """[N, 3] -> (head, xs[site][coord] of [M], tail); one transpose."""
    o, c = params.offset, params.count
    t = jnp.transpose(x[o:o + 3 * c].reshape(c, 3, 3), (1, 2, 0))
    return (x[:o],
            tuple(tuple(t[s, d] for d in range(3)) for s in range(3)),
            x[o + 3 * c:])


def _soa_pack(head, xs, tail):
    """Inverse of :func:`_soa_view`."""
    t = jnp.stack([jnp.stack(list(row)) for row in xs])      # [3, 3, M]
    return jnp.concatenate(
        [head, jnp.transpose(t, (2, 0, 1)).reshape(-1, 3), tail], axis=0)


def _bond_soa(xs):
    """xs[site][coord] -> bond vectors d[bond][coord], each [M]."""
    return tuple(tuple(xs[_BOND_I[k]][c] - xs[_BOND_J[k]][c]
                       for c in range(3)) for k in range(3))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _solve33_soa(a, b):
    """Closed-form adjugate solve on scalar-indexed [M] components:
    a[k][l], b[k] -> x[k]."""
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = 1.0 / det
    return ((c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det,
            (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det,
            (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det)


def _displace_soa(lam, d_ref, im):
    """dx[site][coord] from bond impulses (im[site] = per-site 1/m
    scalars): x_i += 2 lam_k d_ref_k / m_i with incidence signs."""
    dx = [[None, None, None] for _ in range(3)]
    for k in range(3):
        for c in range(3):
            imp = 2.0 * lam[k] * d_ref[k][c]
            i, j = _BOND_I[k], _BOND_J[k]
            vi = imp * im[i]
            vj = -imp * im[j]
            dx[i][c] = vi if dx[i][c] is None else dx[i][c] + vi
            dx[j][c] = vj if dx[j][c] is None else dx[j][c] + vj
    return dx


# ---------------------------------------------------------------------------
# General distance constraints (parallel SHAKE/RATTLE)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistanceConstraints:
    """Arbitrary pairwise distance constraints — the OpenMM
    ``constraints=HBonds``-style L0 service for topologies that are not
    contiguous 3-site waters (solute X-H bonds, mixed systems).

    Shape: one Jacobi-SHAKE sweep is a [C]-vector update (one
    row gather of each endpoint, one scatter-add of the impulses —
    deterministic under XLA), iterated a *fixed* ``n_iter`` times so the
    whole projection is straight-line code under jit; non-convergence
    NaN-poisons the positions (house failure-detection style) instead of
    silently approximating.  Jacobi (simultaneous) sweeps converge for
    molecular constraint graphs at ``omega`` <= 2/(1+max coupling); the
    default 1.0 handles chains and X-Hn centers, and the poison guard
    makes a too-optimistic setting visible.  The fully-coupled water
    triangle contracts at ~0.78/sweep under Jacobi (measured), so the
    128-sweep default reaches f64 machine residuals from MD-size
    violations; each sweep is O(C) vector work.  The contiguous rigid-water
    template keeps the faster closed-form path (:class:`RigidWaterParams`,
    exact 3x3 Newton, no gathers); this class is the general fallback —
    both plug into the same ``constraints=`` slot of every driver.
    """

    idx: jax.Array        # [C, 2] int32 endpoint atom ids
    targets2: jax.Array   # [C] squared target lengths, nm^2
    inv_m: jax.Array      # [N] per-atom inverse masses, 1/amu
    n_iter: int = dataclasses.field(default=128,
                                    metadata=dict(static=True))
    omega: float = dataclasses.field(default=1.0,
                                     metadata=dict(static=True))

    @classmethod
    def create(cls, pairs, lengths, masses, n_iter: int = 128,
               omega: float = 1.0, dtype=jnp.float64):
        pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
        lengths = np.asarray(lengths, np.float64).reshape(-1)
        if pairs.shape[0] != lengths.shape[0]:
            raise ValueError("one target length per constrained pair")
        return cls(idx=jnp.asarray(pairs),
                   targets2=jnp.asarray(lengths * lengths, dtype),
                   inv_m=1.0 / jnp.asarray(np.asarray(masses), dtype),
                   n_iter=n_iter, omega=omega)

    @property
    def n_constraints(self) -> int:
        return int(self.idx.shape[0])


def _shake_positions(x_old, x_unc, p: DistanceConstraints, tol=None):
    """Parallel-SHAKE position projection: corrections along the
    ``x_old`` bond directions with mass weighting (valid constraint
    impulses — per-cluster COM and angular momentum preserved), same
    fixed-point equations as the closed-form water path."""
    dtype = x_unc.dtype
    if tol is None:
        tol = 1e-10 if dtype == jnp.float64 else 1e-4
    i, j = p.idx[:, 0], p.idx[:, 1]
    im = p.inv_m.astype(dtype)
    im_i, im_j = im[i], im[j]
    t2 = p.targets2.astype(dtype)
    d_ref = x_old[i] - x_old[j]                        # [C, 3]
    denom = 2.0 * (im_i + im_j)

    def body(x, _):
        d = x[i] - x[j]
        c = jnp.sum(d * d, axis=-1) - t2
        g = jnp.sum(d * d_ref, axis=-1)
        dlam = p.omega * c / (denom * g)
        corr = dlam[:, None] * d_ref
        return (x.at[i].add(-corr * im_i[:, None])
                 .at[j].add(corr * im_j[:, None])), None

    x, _ = jax.lax.scan(body, x_unc, None, length=p.n_iter)
    d = x[i] - x[j]
    res = jnp.max(jnp.abs(jnp.sum(d * d, axis=-1) - t2))
    poison = jnp.where(res > tol, jnp.asarray(jnp.nan, dtype), 1.0)
    return x * poison


def _shake_velocities(x, v_unc, p: DistanceConstraints, tol=None):
    """Parallel-RATTLE velocity projection (J v = 0 along current bonds).
    The multiplier system is linear; the same Jacobi sweeps apply, with
    the same visibility contract (residual past tol poisons)."""
    dtype = v_unc.dtype
    if tol is None:
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
    i, j = p.idx[:, 0], p.idx[:, 1]
    im = p.inv_m.astype(dtype)
    im_i, im_j = im[i], im[j]
    d = x[i] - x[j]
    d2 = jnp.sum(d * d, axis=-1)
    denom = d2 * (im_i + im_j)

    def body(v, _):
        dv = v[i] - v[j]
        c = jnp.sum(d * dv, axis=-1)
        dmu = p.omega * c / denom
        corr = dmu[:, None] * d
        return (v.at[i].add(-corr * im_i[:, None])
                 .at[j].add(corr * im_j[:, None])), None

    v, _ = jax.lax.scan(body, v_unc, None, length=p.n_iter)
    dv = v[i] - v[j]
    # residual in relative-velocity units (nm/ps) along the unit bond
    res = jnp.max(jnp.abs(jnp.sum(d * dv, axis=-1)) / jnp.sqrt(d2))
    poison = jnp.where(res > tol, jnp.asarray(jnp.nan, dtype), 1.0)
    return v * poison


# Rigid-water position-projection algorithm: "newton" (iterated 3x3
# Lagrange solve, works for any isoceles/scalene triangle) or "settle"
# (closed-form Miyamoto-Kollman rotation, isoceles only — which
# RigidWaterParams.create guarantees by construction).  Both solve the
# SAME SHAKE equations; SETTLE is the analytic solution, so they agree
# to machine precision (tests pin it) — the knob is purely a speed
# choice.  Module-level for the same reason as integrate.PACKED_CARRY_MODE.
# Default "settle": closed-form (no iteration, no residual-poison branch
# to schedule); its speed against "newton" on the card awaits an A/B.
RIGID_PROJECTION = "settle"


def _cross_soa(u, v):
    """Component tuples ([M],)x3 -> cross product, same shape."""
    return (u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0])


def _unit_soa(u):
    inv = jax.lax.rsqrt(_dot3(u, u))
    return (u[0] * inv, u[1] * inv, u[2] * inv)


def settle_positions(x_old, x_unc, params: RigidWaterParams):
    """Closed-form SETTLE position projection (Miyamoto & Kollman,
    J. Comput. Chem. 13, 952 (1992)): the analytic solution of the same
    SHAKE equations :func:`project_positions`'s Newton path iterates —
    corrections are valid constraint impulses from ``x_old``'s geometry,
    so per-molecule COM and angular momentum are exactly preserved and
    the result matches the converged Newton solve to machine precision
    (tests/test_constraints.py pins f64 parity).

    Shape: the rotation (phi, psi, theta) is straight-line
    [M]-vector arithmetic on the SoA site components — no iteration, so
    one projection costs ~1/4 of the 4-sweep Newton path.  Requires the
    isoceles OH1 == OH2 geometry ``RigidWaterParams.create`` produces.
    A degenerate proposal (step so wild a rotation cannot restore the
    triangle) makes a sqrt argument negative and the molecule NaN-poisons
    — visible, never silently approximate (house failure-detection
    style)."""
    head, xo, tail = _soa_view(x_old, params)
    _, xu, _ = _soa_view(x_unc, params)
    dtype = x_unc.dtype
    im = params.inv_m.astype(dtype)
    t2 = params.targets2.astype(dtype)
    m_o, m_h = 1.0 / im[0], 1.0 / im[1]

    # canonical isoceles geometry (origin at molecule COM, O on +y):
    # O = (0, ra), H = (-+rc, -rb) with rc = d_HH/2 and ra + rb = the
    # O-to-HH-line height h
    rc = 0.5 * jnp.sqrt(t2[2])
    h = jnp.sqrt(t2[0] - 0.25 * t2[2])
    ra = 2.0 * m_h * h / (m_o + 2.0 * m_h)
    rb = h - ra

    # unconstrained COM (constraint impulses cannot move it)
    w_o = m_o / (m_o + 2.0 * m_h)
    w_h = m_h / (m_o + 2.0 * m_h)
    com = tuple(w_o * xu[0][c] + w_h * (xu[1][c] + xu[2][c])
                for c in range(3))
    a1 = tuple(xu[0][c] - com[c] for c in range(3))
    b1 = tuple(xu[1][c] - com[c] for c in range(3))
    c1 = tuple(xu[2][c] - com[c] for c in range(3))
    b0 = tuple(xo[1][c] - xo[0][c] for c in range(3))
    c0 = tuple(xo[2][c] - xo[0][c] for c in range(3))

    # molecule frame: ez _|_ old plane, ex _|_ (new O offset, ez), ey
    # completes — a1 lies in the (y, z) plane so a1.ex = 0
    ez = _unit_soa(_cross_soa(b0, c0))
    ex = _unit_soa(_cross_soa(a1, ez))
    ey = _unit_soa(_cross_soa(ez, ex))

    xb0 = _dot3(b0, ex)
    yb0 = _dot3(b0, ey)
    xc0 = _dot3(c0, ex)
    yc0 = _dot3(c0, ey)
    za1 = _dot3(a1, ez)
    xb1, yb1, zb1 = _dot3(b1, ex), _dot3(b1, ey), _dot3(b1, ez)
    xc1, yc1, zc1 = _dot3(c1, ex), _dot3(c1, ey), _dot3(c1, ez)

    # out-of-plane tilt (phi) and twist (psi) from the z components
    sinphi = za1 / ra
    cosphi = jnp.sqrt(1.0 - sinphi * sinphi)
    sinpsi = (zb1 - zc1) / (2.0 * rc * cosphi)
    cospsi = jnp.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    t_b = -rb * cosphi
    t_c = rc * sinpsi * sinphi
    yb2 = t_b - t_c
    yc2 = t_b + t_c

    # in-plane rotation (theta) closing the old-geometry projection
    alpha = xb2 * (xb0 - xc0) + yb0 * yb2 + yc0 * yc2
    beta = xb2 * (yc0 - yb0) + xb0 * yb2 + xc0 * yc2
    gamma = xb0 * yb1 - xb1 * yb0 + xc0 * yc1 - xc1 * yc0
    a2b2 = alpha * alpha + beta * beta
    sinth = (alpha * gamma
             - beta * jnp.sqrt(a2b2 - gamma * gamma)) / a2b2
    costh = jnp.sqrt(1.0 - sinth * sinth)

    xa3 = -ya2 * sinth
    ya3 = ya2 * costh
    xb3 = xb2 * costh - yb2 * sinth
    yb3 = xb2 * sinth + yb2 * costh
    xc3 = -xb2 * costh - yc2 * sinth
    yc3 = -xb2 * sinth + yc2 * costh

    def back(xd, yd, zd):
        return tuple(com[c] + xd * ex[c] + yd * ey[c] + zd * ez[c]
                     for c in range(3))

    xm = (back(xa3, ya3, za1), back(xb3, yb3, zb1), back(xc3, yc3, zc1))
    return _soa_pack(head, xm, tail)


def project_positions(x_old, x_unc, params, n_iter: int = 4,
                      tol: float = None, method: str | None = None):
    """RATTLE position projection: returns x_new with every rigid-water
    bond restored to its target length, reached from ``x_unc`` along the
    mass-weighted constraint gradients of ``x_old`` (so the correction is
    a valid constraint impulse: COM and angular momentum of each molecule
    are exactly preserved).

    ``x_old`` must satisfy the constraints (the previous step's output).
    ``method`` (default :data:`RIGID_PROJECTION`) picks the rigid-water
    solver: "newton" iterates the 3x3 multiplier system and poisons if
    the final residual exceeds ``tol`` (default: 1e-10 f64 / 1e-4 f32,
    in nm^2); "settle" computes the same solution in closed form
    (:func:`settle_positions`, no residual check needed — it is exact up
    to rounding).

    A :class:`DistanceConstraints` params takes the general parallel-SHAKE
    route instead (same fixed-point equations, arbitrary topology).
    """
    if isinstance(params, DistanceConstraints):
        return _shake_positions(x_old, x_unc, params, tol)
    if (RIGID_PROJECTION if method is None else method) == "settle":
        return settle_positions(x_old, x_unc, params)
    head, xo, tail = _soa_view(x_old, params)
    _, xu, _ = _soa_view(x_unc, params)
    dtype = x_unc.dtype
    if tol is None:
        tol = 1e-10 if dtype == jnp.float64 else 1e-4
    inv_m = params.inv_m.astype(dtype)
    im = [inv_m[s] for s in range(3)]                 # per-site scalars
    t2 = params.targets2.astype(dtype)
    d_old = _bond_soa(xo)
    w = _mass_coupling(inv_m)                         # [3, 3] scalars

    def corrected(lam):
        dx = _displace_soa(lam, d_old, im)
        return tuple(tuple(xu[s][c] + dx[s][c] for c in range(3))
                     for s in range(3))

    zero = jnp.zeros((params.count,), dtype)
    lam = (zero, zero, zero)
    for _ in range(n_iter):
        d = _bond_soa(corrected(lam))
        g = tuple(_dot3(d[k], d[k]) - t2[k] for k in range(3))
        # A[k,l] = dg_k/dlam_l = 4 w[k,l] (d_k . d_old_l)
        a = [[4.0 * w[k, l] * _dot3(d[k], d_old[l]) for l in range(3)]
             for k in range(3)]
        dl = _solve33_soa(a, g)
        lam = tuple(lam[k] - dl[k] for k in range(3))

    xm = corrected(lam)
    d = _bond_soa(xm)
    res = [jnp.max(jnp.abs(_dot3(d[k], d[k]) - t2[k])) for k in range(3)]
    bad = jnp.maximum(jnp.maximum(res[0], res[1]), res[2]) > tol
    poison = jnp.where(bad, jnp.asarray(jnp.nan, dtype), 1.0)
    xm = tuple(tuple(xm[s][c] * poison for c in range(3)) for s in range(3))
    return _soa_pack(head, xm, tail)


def project_velocities(x, v_unc, params: RigidWaterParams):
    """RATTLE velocity projection: returns v with the relative velocity
    along every constrained bond removed (J v = 0), via one exact 3x3
    solve per molecule.  Preserves each molecule's COM velocity and
    angular momentum (impulses are along the bonds).

    A :class:`DistanceConstraints` params takes the general parallel-
    RATTLE route instead."""
    if isinstance(params, DistanceConstraints):
        return _shake_velocities(x, v_unc, params)
    head, xm, tail = _soa_view(x, params)
    _, vm, _ = _soa_view(v_unc, params)
    dtype = v_unc.dtype
    inv_m = params.inv_m.astype(dtype)
    im = [inv_m[s] for s in range(3)]
    d = _bond_soa(xm)
    dv = _bond_soa(vm)                                        # relative v
    g = tuple(_dot3(d[k], dv[k]) for k in range(3))           # J v / 2
    w = _mass_coupling(inv_m)
    a = [[w[k, l] * _dot3(d[k], d[l]) for l in range(3)] for k in range(3)]
    mu = _solve33_soa(a, tuple(-gk for gk in g))
    dx = _displace_soa(tuple(0.5 * m_ for m_ in mu), d, im)
    vm = tuple(tuple(vm[s][c] + dx[s][c] for c in range(3))
               for s in range(3))
    return _soa_pack(head, vm, tail)


def constraint_residuals(x, params):
    """Squared-length violations (diagnostics/tests): [count, 3] for the
    rigid-water template, [C] for general distance constraints."""
    if isinstance(params, DistanceConstraints):
        d = x[params.idx[:, 0]] - x[params.idx[:, 1]]
        return jnp.sum(d * d, axis=-1) - params.targets2.astype(x.dtype)
    _, xm, _ = _mol_view(x, params)
    d = _bond_vectors(xm)
    return jnp.sum(d * d, axis=-1) - params.targets2.astype(x.dtype)


# ---------------------------------------------------------------------------
# Constrained integrators
# ---------------------------------------------------------------------------


def rattle_verlet_step(x, v, f, energy_fn, masses, dt: float,
                       params: RigidWaterParams):
    """One velocity-Verlet step with RATTLE position+velocity projections
    (the rigid-water analog of integrate.nve_step).  Returns
    (x, v, f, potential)."""
    inv_m = (1.0 / masses)[:, None]
    v_half = v + 0.5 * dt * f * inv_m
    x_unc = x + dt * v_half
    x_new = project_positions(x, x_unc, params)
    v_half = (x_new - x) / dt          # constraint impulse folded into v
    e, g = jax.value_and_grad(energy_fn)(x_new)
    f_new = -g
    v_new = v_half + 0.5 * dt * f_new * inv_m
    v_new = project_velocities(x_new, v_new, params)
    return x_new, v_new, f_new, e


def rattle_nve_trajectory(x, v, energy_fn, masses, dt: float, n_steps: int,
                          params: RigidWaterParams):
    """n_steps of constrained NVE (lax.scan on a packed [N, 9] carry, like
    integrate.nve_trajectory).  Returns ((x, v, f, potential), per-step
    total energies).  Initial velocities are projected onto the
    constraint manifold first."""
    from .integrate import kinetic_energy

    masses = jnp.asarray(masses)
    v = project_velocities(x, v, params)
    e0, g0 = jax.value_and_grad(energy_fn)(x)

    def body(p, _):
        xx, vv, ff = p[:, 0:3], p[:, 3:6], p[:, 6:9]
        xx, vv, ff, e = rattle_verlet_step(xx, vv, ff, energy_fn, masses,
                                           dt, params)
        return (jnp.concatenate([xx, vv, ff], axis=1),
                e + kinetic_energy(vv, masses))

    p0 = jnp.concatenate([x, v, -g0], axis=1)
    p, etots = jax.lax.scan(body, p0, None, length=n_steps)
    return (p[:, 0:3], p[:, 3:6], p[:, 6:9], energy_fn(p[:, 0:3])), etots


def rattle_langevin_trajectory_nb(state, e_fn, init_nb, masses, dt: float,
                                  temperature: float, friction: float, key,
                                  n_steps: int, params: RigidWaterParams,
                                  rebuild_every: int = 10):
    """Constrained BAOAB with neighbor-state reuse — the rigid-water
    analog of integrate.langevin_trajectory_nb (same packed [N, 9] carry,
    unconditional nested-scan rebuilds, freshness guard through ``e_fn``),
    with RATTLE projections at every B/A/O stage.  ``state`` is an
    integrate.MDStateNB; returns (final_state, per-step kinetic
    energies).

    Resumable to round-off (NOT bitwise, unlike
    integrate.langevin_trajectory_nb): resume from the returned state
    with ``integrate.advance_key(key, n_steps // rebuild_every)``.  The
    final state keeps the carry forces, but the initial velocity
    projection re-solves the 3x3 constraint system on an
    already-projected state, perturbing the last bits (~1e-12 relative;
    tests/test_integrate.py::test_rattle_langevin_nb_resume_exact pins
    the tolerance)."""
    from .integrate import (MDStateNB, baoab_coeffs, kinetic_energy,
                            x_into_energy)

    if n_steps % rebuild_every or n_steps <= 0:
        raise ValueError("n_steps must be a positive multiple of "
                         "rebuild_every")
    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature, state.positions.dtype)

    def a_half(xx, vv):
        x_new = project_positions(xx, xx + 0.5 * dt * vv, params)
        return x_new, (x_new - xx) / (0.5 * dt)

    def inner(nb):
        def body(p, kk):
            xx, vv, ff = p[:, 0:3], p[:, 3:6], p[:, 6:9]
            vv = project_velocities(xx, vv + 0.5 * dt * ff * inv_m,
                                    params)                            # B
            xx, vv = a_half(xx, vv)                                    # A
            noise = jax.random.normal(kk, vv.shape, dtype=vv.dtype)
            vv = project_velocities(
                xx, c1 * vv + c2 * jnp.sqrt(inv_m) * noise, params)    # O
            xx, vv = a_half(xx, vv)                                    # A
            _e, f, _nb = e_fn(x_into_energy(xx), nb)
            vv = project_velocities(xx, vv + 0.5 * dt * f * inv_m,
                                    params)                            # B
            return (jnp.concatenate([xx, vv, f], axis=1),
                    kinetic_energy(vv, masses))
        return body

    def outer(carry, _):
        p, k = carry
        k, sub = jax.random.split(k)
        nb = init_nb(p[:, 0:3])
        p, kes = jax.lax.scan(inner(nb), p,
                              jax.random.split(sub, rebuild_every))
        return (p, k), kes

    v0 = project_velocities(state.positions, state.velocities, params)
    p0 = jnp.concatenate([state.positions, v0, state.forces], axis=1)
    (p, _k), kes = jax.lax.scan(outer, (p0, key), None,
                                length=n_steps // rebuild_every)
    x = p[:, 0:3]
    nb = init_nb(x)
    e_pot, _f, nb = e_fn(x, nb)
    final = MDStateNB(x, p[:, 3:6], p[:, 6:9], e_pot, nb)
    return final, kes.reshape(-1)


def rattle_langevin_trajectory(x, v, energy_fn, masses, dt: float,
                               temperature: float, friction: float, key,
                               n_steps: int, params: RigidWaterParams):
    """Constrained BAOAB (Leimkuhler-Matthews "g-BAOAB" with one
    projection per stage): O-step noise is projected back onto the
    constraint manifold, position half-kicks are RATTLE-projected.
    Returns ((x, v, f, potential), per-step kinetic energies)."""
    from .integrate import baoab_coeffs, kinetic_energy

    masses = jnp.asarray(masses)
    inv_m = (1.0 / masses)[:, None]
    c1, c2 = baoab_coeffs(dt, friction, temperature, x.dtype)
    v = project_velocities(x, v, params)
    e0, g0 = jax.value_and_grad(energy_fn)(x)

    def a_half(xx, vv):
        x_unc = xx + 0.5 * dt * vv
        x_new = project_positions(xx, x_unc, params)
        return x_new, (x_new - xx) / (0.5 * dt)

    def body(p, kk):
        xx, vv, ff = p[:, 0:3], p[:, 3:6], p[:, 6:9]
        vv = project_velocities(xx, vv + 0.5 * dt * ff * inv_m, params)  # B
        xx, vv = a_half(xx, vv)                                          # A
        noise = jax.random.normal(kk, vv.shape, dtype=vv.dtype)
        vv = project_velocities(xx, c1 * vv + c2 * jnp.sqrt(inv_m) * noise,
                                params)                                  # O
        xx, vv = a_half(xx, vv)                                          # A
        e, g = jax.value_and_grad(energy_fn)(xx)
        vv = project_velocities(xx, vv + 0.5 * dt * (-g) * inv_m, params)  # B
        return (jnp.concatenate([xx, vv, -g], axis=1),
                kinetic_energy(vv, masses))

    p0 = jnp.concatenate([x, v, -g0], axis=1)
    p, kes = jax.lax.scan(body, p0, jax.random.split(key, n_steps))
    return (p[:, 0:3], p[:, 3:6], p[:, 6:9], energy_fn(p[:, 0:3])), kes
