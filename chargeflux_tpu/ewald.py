"""Ewald summation.

Replaces the reference's brute-force O(N*K) reciprocal loop
(ReferenceCoulKernels.cpp:519-556; CUDA PBCForce.cu:841-950, one thread per
k-vector) with a *factorized structure-factor* formulation that is one GEMM:

    S(k) = sum_i q_i e^{i k.x_i},   k = 2*pi*(nx/Lx, ny/Ly, nz/Lz)

factorizes as e^{i k.x} = Ex_i(nx) * Ey_i(ny) * Ez_i(nz).  We build per-axis
phase tables (O(N*(Kx+Ky+Kz)) transcendentals instead of O(N*K)), combine the
x/y tables elementwise, and contract over atoms with a single complex matmul
[Kx*Ky, N] @ [N, 2Kz], which XLA hands to the GEMM library.  Forces come from
jax.grad: the VJP of a matmul is a matmul, so the reciprocal force pass (the
reference's computeEwaldRecForce, PBCForce.cu:891-950) is *derived*, not
hand-written, and is matrix products too.

Half-space enumeration parity: the reference sums kx in [0,kmax), with only a
half (ky,kz)-plane when kx==0 (the minky/minkz trick,
ReferenceCoulKernels.cpp:519-556).  Since |S(-k)| = |S(k)|, that equals a sum
over kx in [0,kmax) x full (ky,kz) grid with weight 1 for kx>0 and 1/2 for
kx==0, origin excluded.  We use the weighted full-plane form — identical
value, branch-free.

Energy:  E_rec = (4*pi*k_e/V) * sum_k w(k) * exp(-k^2/(4 alpha^2))/k^2 * |S(k)|^2
(ReferenceCoulKernels.cpp:517, 527-550).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pairs import box_volume, frac_coords, reciprocal_metric
from .units import ONE_4PI_EPS0, SQRT_PI


#: Algorithm of every accuracy-relevant f32 dot (the structure-factor
#: GEMM here, the PME spreads in pme.py): three bf16 products with f32
#: accumulation, about f32 accuracy.  A dot left at the default precision
#: may run in a reduced-precision mode (TF32 on the GPU's tensor cores),
#: which spends the 1e-4 force-RMSE budget (tests/test_pme.py).
F32_DOT_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def dot_precision(dtype):
    """``precision=`` for an accuracy-relevant dot in ``dtype``: the
    pinned f32 algorithm, or the default (exact) for f64."""
    return F32_DOT_PRECISION if jnp.dtype(dtype) == jnp.float32 else None


def kvector_grid(kmax: Tuple[int, int, int]):
    """Static (numpy, trace-time) k-space integer grid and weights.

    Returns (nx [Kx], ny [Ky], nz [Kz], w [Kx,Ky,Kz]) where Kx = kmaxx,
    Ky = 2*kmaxy - 1, Kz = 2*kmaxz - 1; w is 1 for nx>0, 0.5 for nx==0,
    0 at the origin.
    """
    kx, ky, kz = kmax
    nx = np.arange(0, kx)
    ny = np.arange(-(ky - 1), ky)
    nz = np.arange(-(kz - 1), kz)
    w = np.where(nx[:, None, None] > 0, 1.0, 0.5) * np.ones((len(nx), len(ny), len(nz)))
    origin = (nx[:, None, None] == 0) & (ny[None, :, None] == 0) & (nz[None, None, :] == 0)
    w = np.where(origin, 0.0, w)
    return nx, ny, nz, w


def structure_factors(positions: jax.Array, q: jax.Array, box: jax.Array,
                      kmax: Tuple[int, int, int]):
    """Structure factors S(k) = sum_i q_i e^{i k.x_i} over the weighted
    half-space grid, as (s_cos, s_sin) each [Kx*Ky, Kz].

    The atom contraction is a complex matmul — this is the piece that is
    *additive over atoms*, so a sharded engine computes it on an atom chunk
    and psums the result (SURVEY §2: replicated-k reciprocal sum with psum of
    structure factors).
    """
    dtype = positions.dtype
    nx, ny, nz, _ = kvector_grid(kmax)
    nx = jnp.asarray(nx, dtype)
    ny = jnp.asarray(ny, dtype)
    nz = jnp.asarray(nz, dtype)

    # Fractional coordinates wrapped into [0, 1): improves phase accuracy in
    # f32 and leaves the (periodic) energy unchanged; floor has zero grad.
    # e^{i k.x} = e^{2 pi i n.f} factorizes per axis in *fractional* space
    # for any lattice — the same factorized contraction serves triclinic
    # boxes (an extension; the reference is orthorhombic-only).
    frac = frac_coords(positions, box)
    frac = frac - jax.lax.stop_gradient(jnp.floor(frac))
    two_pi = 2.0 * math.pi
    phx = two_pi * frac[:, 0:1] * nx[None, :]          # [N, Kx]
    phy = two_pi * frac[:, 1:2] * ny[None, :]          # [N, Ky]
    phz = two_pi * frac[:, 2:3] * nz[None, :]          # [N, Kz]
    cx, sx = jnp.cos(phx), jnp.sin(phx)
    cy, sy = jnp.cos(phy), jnp.sin(phy)
    cz, sz = jnp.cos(phz), jnp.sin(phz)

    # Combine x and y phases, weighting by charge on the atom axis.
    # cxy/sxy: [N, Kx, Ky] -> [N, Kx*Ky]
    n_at = positions.shape[0]
    cxy = (cx[:, :, None] * cy[:, None, :] - sx[:, :, None] * sy[:, None, :])
    sxy = (sx[:, :, None] * cy[:, None, :] + cx[:, :, None] * sy[:, None, :])
    qcol = q[:, None]
    kxy = len(nx) * len(ny)
    cxy = (qcol * cxy.reshape(n_at, kxy))
    sxy = (qcol * sxy.reshape(n_at, kxy))

    # Structure factors: S = sum_i (cxy + i sxy)(cz + i sz) -> two real parts.
    # [Kx*Ky, Kz] each; the contraction over atoms is a GEMM.  The z factors
    # are concatenated so each large [N, Kx*Ky] operand is read exactly once
    # (2 matmuls instead of 4 -> half the memory traffic).
    dot = partial(jnp.matmul, preferred_element_type=dtype,
                  precision=dot_precision(dtype))
    cz_sz = jnp.concatenate([cz, sz], axis=1)           # [N, 2*Kz]
    kz = len(nz)
    a = dot(cxy.T, cz_sz)                               # [Kxy, 2*Kz]
    b = dot(sxy.T, cz_sz)
    s_cos = a[:, :kz] - b[:, kz:]
    s_sin = b[:, :kz] + a[:, kz:]
    return s_cos, s_sin


def reciprocal_energy_from_sf(s_cos: jax.Array, s_sin: jax.Array,
                              box: jax.Array, alpha: float,
                              kmax: Tuple[int, int, int]) -> jax.Array:
    """E_rec from assembled structure factors (replicated-k part)."""
    dtype = s_cos.dtype
    nx, ny, nz, w = kvector_grid(kmax)
    # k^2 and the Ewald kernel exp(-k^2/(4 alpha^2)) / k^2, origin masked.
    if box.ndim == 2:
        # triclinic: |k|^2 = n.G.n with the reciprocal Gram matrix — the
        # three cross terms are the only difference from the separable form
        g = reciprocal_metric(box, dtype)
        ax = jnp.asarray(nx, dtype)[:, None, None]
        ay = jnp.asarray(ny, dtype)[None, :, None]
        az = jnp.asarray(nz, dtype)[None, None, :]
        k2 = (g[0, 0] * ax * ax + g[1, 1] * ay * ay + g[2, 2] * az * az
              + 2.0 * (g[0, 1] * ax * ay + g[0, 2] * ax * az
                       + g[1, 2] * ay * az))
    else:
        recip = (2.0 * math.pi) / box                   # [3]
        kx2 = (jnp.asarray(nx, dtype) * recip[0]) ** 2  # [Kx]
        ky2 = (jnp.asarray(ny, dtype) * recip[1]) ** 2
        kz2 = (jnp.asarray(nz, dtype) * recip[2]) ** 2
        k2 = (kx2[:, None, None] + ky2[None, :, None] + kz2[None, None, :])
    kxy = len(nx) * len(ny)
    k2 = k2.reshape(kxy, len(nz))
    k2_safe = jnp.where(k2 > 0, k2, 1.0)
    eak = jnp.exp(-k2_safe * (0.25 / (alpha * alpha))) / k2_safe
    wk = jnp.asarray(w, dtype).reshape(kxy, len(nz)) * eak

    const = 4.0 * math.pi * ONE_4PI_EPS0 / box_volume(box)
    return const * jnp.sum(wk * (s_cos * s_cos + s_sin * s_sin))


def reciprocal_energy(positions: jax.Array, q: jax.Array, box: jax.Array,
                      alpha: float, kmax: Tuple[int, int, int]) -> jax.Array:
    """Reciprocal-space Ewald energy via factorized complex matmuls."""
    s_cos, s_sin = structure_factors(positions, q, box, kmax)
    return reciprocal_energy_from_sf(s_cos, s_sin, box, alpha, kmax)


def self_energy(q: jax.Array, alpha: float) -> jax.Array:
    """E_self = -k_e * alpha/sqrt(pi) * sum q_i^2
    (ReferenceCoulKernels.cpp:507-510)."""
    return -ONE_4PI_EPS0 * alpha / SQRT_PI * jnp.sum(q * q)
