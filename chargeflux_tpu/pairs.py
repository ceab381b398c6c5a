"""Displacement geometry and dense pair masking.

Replaces the reference's use of OpenMM ``ReferenceForce::getDeltaR`` /
``getDeltaRPeriodic`` (ReferenceCoulKernels.cpp:52-56, 93-101, 172-181) and
the per-atom exclusion sets (ReferenceCoulKernels.cpp:385-391).

Minimum-image convention: for an orthorhombic box ([3] edge lengths) we use
``delta - box * floor(delta / box + 0.5)``, matching OpenMM's reference
implementation exactly (round-half-up at the box boundary).  The reference
plugin bakes in the orthorhombic assumption (ReferenceCoulKernels.cpp:
513-517); as an extension a *triclinic* box may be given as a [3, 3] matrix
of row lattice vectors in reduced lower-triangular form, wrapped by the
sequential c-then-b-then-a subtraction (OpenMM's triclinic convention) —
exact for pair distances up to half the smallest perpendicular box width,
which create_system enforces against the cutoff.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def delta_direct(pa: jax.Array, pb: jax.Array) -> jax.Array:
    """Displacement a -> b without PBC: pb - pa."""
    return pb - pa


def delta_periodic(pa: jax.Array, pb: jax.Array, box: jax.Array) -> jax.Array:
    """Minimum-image displacement a -> b.

    ``box`` is a length-3 vector of edge lengths (orthorhombic), broadcast
    against the last axis of the positions, or a [3, 3] reduced-form
    row-vector matrix (triclinic; the shape dispatch is static).
    """
    d = pb - pa
    if box.ndim == 2:
        d = d - box[2] * jnp.floor(d[..., 2:3] / box[2, 2] + 0.5)
        d = d - box[1] * jnp.floor(d[..., 1:2] / box[1, 1] + 0.5)
        d = d - box[0] * jnp.floor(d[..., 0:1] / box[0, 0] + 0.5)
        return d
    return d - box * jnp.floor(d / box + 0.5)


def displacement(pa, pb, box, pbc: bool):
    """Dispatch on the static pbc flag (trace-time branch)."""
    if pbc:
        return delta_periodic(pa, pb, box)
    return delta_direct(pa, pb)


def box_volume(box: jax.Array) -> jax.Array:
    """Box volume: edge product ([3]) or diagonal product of the reduced
    lower-triangular lattice matrix ([3, 3] — its determinant)."""
    if box.ndim == 2:
        return box[0, 0] * box[1, 1] * box[2, 2]
    return box[0] * box[1] * box[2]


def box_inverse(box: jax.Array) -> jax.Array:
    """Closed-form inverse of the reduced lower-triangular [3, 3] lattice
    matrix (row vectors).  Exact back-substitution — no linalg solve, safe
    under jit with a traced box."""
    b00, b11, b22 = box[0, 0], box[1, 1], box[2, 2]
    i00 = 1.0 / b00
    i11 = 1.0 / b11
    i22 = 1.0 / b22
    i10 = -box[1, 0] * (i00 * i11)
    i21 = -box[2, 1] * (i11 * i22)
    i20 = (box[1, 0] * box[2, 1] - box[2, 0] * b11) * (i00 * i11 * i22)
    z = jnp.zeros_like(b00)
    return jnp.stack([jnp.stack([i00, z, z]),
                      jnp.stack([i10, i11, z]),
                      jnp.stack([i20, i21, i22])])


def frac_coords(x: jax.Array, box: jax.Array) -> jax.Array:
    """Fractional coordinates f with x = f @ box (rows = lattice vectors);
    for an orthorhombic [3] box this is x / box.

    The triclinic transform is expanded ELEMENTWISE (not an [N,3]@[3,3]
    dot): an f32 matmul at the default precision may run in a reduced
    mode (TF32 on the GPU's tensor cores, ~2^-11 relative), which would
    put that error straight into coordinates on an accuracy-relevant path
    (repo precision rule: accuracy-relevant f32 dots pin their
    precision)."""
    if box.ndim == 2:
        inv = box_inverse(box)
        f0 = x[..., 0] * inv[0, 0] + x[..., 1] * inv[1, 0] \
            + x[..., 2] * inv[2, 0]
        f1 = x[..., 1] * inv[1, 1] + x[..., 2] * inv[2, 1]
        f2 = x[..., 2] * inv[2, 2]
        return jnp.stack([f0, f1, f2], axis=-1)
    return x / box


def lattice_cart(n: jax.Array, box: jax.Array) -> jax.Array:
    """Cartesian coordinates of lattice/fractional vectors ``n`` (last axis
    3): ``n @ box`` for a [3, 3] row-vector lattice, ``n * box`` for an
    orthorhombic [3] box — expanded elementwise for the same f32 matmul
    precision reason as :func:`frac_coords`."""
    if box.ndim == 2:
        return (n[..., 0:1] * box[0] + n[..., 1:2] * box[1]
                + n[..., 2:3] * box[2])
    return n * box


def plane_widths(box: jax.Array) -> jax.Array:
    """Perpendicular widths (lattice-plane spacings) as a traced [3] array:
    the box itself for an orthorhombic [3] box; 1 / ||inv(B)[:, i]|| for a
    [3, 3] row-vector lattice (traced analog of system.box_widths — used by
    the in-jit cell-edge and PME-drift safety checks under a barostat-moved
    box)."""
    if box.ndim == 2:
        inv = box_inverse(box)
        return 1.0 / jnp.sqrt(jnp.sum(inv * inv, axis=0))
    return box


def reciprocal_metric(box: jax.Array, dtype) -> jax.Array:
    """G [3, 3] such that |k(n)|^2 = n . G . n for k = 2 pi n B^-T
    (the reciprocal-lattice Gram matrix, G = (2 pi)^2 (B B^T)^-1).
    Diagonal (2 pi / L_i)^2 for an orthorhombic box."""
    if box.ndim == 2:
        b = box.astype(dtype)
        g = jnp.linalg.inv(jnp.matmul(b, b.T,
                                      precision=jax.lax.Precision.HIGHEST))
        return (2.0 * jnp.pi) ** 2 * g
    r = (2.0 * jnp.pi) / box.astype(dtype)
    return jnp.diag(r * r)


def safe_norm(d: jax.Array, axis: int = -1):
    """(r, r^2) with a grad-safe sqrt: where r^2 == 0 the norm is 0 with zero
    gradient instead of NaN (the double-where trick)."""
    r2 = jnp.sum(d * d, axis=axis)
    nonzero = r2 > 0
    r2_safe = jnp.where(nonzero, r2, 1.0)
    r = jnp.where(nonzero, jnp.sqrt(r2_safe), 0.0)
    return r, r2


def pair_matrix_mask(n: int, exclusions: jax.Array, dtype=jnp.bool_) -> jax.Array:
    """[N, N] mask of interacting ordered pairs i < j, with excluded pairs
    removed.

    Encodes the net exclusion *contract* (SURVEY §5): an excluded pair
    contributes neither short-range Coulomb nor LJ.  This replaces both the
    reference CPU's add-then-subtract loops (ReferenceCoulKernels.cpp:464-491)
    and the CUDA compute-all-then-subtract route (PBCForce.cu:753-815) with a
    single static mask — algebraically identical, branch-free under XLA.
    """
    i = jnp.arange(n)
    upper = i[:, None] < i[None, :]
    mask = upper
    if exclusions.shape[0] > 0:
        p1 = exclusions[:, 0]
        p2 = exclusions[:, 1]
        excl = jnp.zeros((n, n), dtype=jnp.bool_)
        excl = excl.at[p1, p2].set(True)
        excl = excl.at[p2, p1].set(True)
        mask = mask & ~excl
    return mask.astype(dtype)
