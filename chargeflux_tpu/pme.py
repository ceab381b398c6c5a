"""Smooth particle-mesh Ewald (SPME) reciprocal space.

Replaces the classical O(N*K) k-space sum (the reference's brute-force
reciprocal loops, ReferenceCoulKernels.cpp:519-556 / PBCForce.cu:841-950,
and ewald.py's factorized equivalent) with the O(N + G^3 log G) SPME
algorithm (Essmann et al., J. Chem. Phys. 103, 8577 (1995)):

    E_rec = (2 pi k_e / V) sum_{m != 0} exp(-k^2/4a^2)/k^2 * |b1 b2 b3|^2 |Q^(m)|^2

where Q is the charge grid spread with cardinal B-splines of order p and
Q^ = FFT(Q).

Design:

* **Spreads without scatters.**  Two spreads share the B-spline weights.
  The dense-separable spread (:func:`pme_reciprocal_energy`) builds per-axis
  weight matrices W[i, g] = M_p((u_i - g) mod G) (mostly zeros, but dense
  [N, G] arrays) and contracts Q[x,y,z] = sum_i q_i Wx[i,x] Wy[i,y] Wz[i,z]
  column block by column block as matrix products.  The cell-blocked
  spread (:func:`pme_cell_reciprocal_energy`, the production route) reuses
  the direct walk's cell blocks: each cell's atoms touch only a static
  patch of the mesh, contracted per cell and folded onto the mesh by
  static placement matrices.  Either way the spread and its backward are
  matrix products, and the spline order p never enters a contraction
  shape, so accuracy is cheap — we default to p=8.
* The periodic wrap is (u - g) mod G inside the spline argument — no index
  arithmetic, and autodiff through the piecewise-polynomial recursion gives
  exact forces (forces are the exact gradient of the computed energy).
* The FFT is XLA's FFT op.
* f32 dots pin one algorithm for every backend (ewald.F32_DOT_PRECISION).

Complexity: the dense-separable contraction is O(N G^3) MAC with O(N G)
memory; the cell-blocked spread is O(N W^3) with W = ceil(G / cells) +
p + 2 per axis.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .ewald import dot_precision
from .pairs import box_inverse, box_volume, frac_coords, reciprocal_metric
from .units import ONE_4PI_EPS0

# Order 8: in the dense/cell-blocked spread the spline order never enters a
# contraction shape, so higher order is nearly free while the mesh shrinks
# at equal accuracy (relF ~= C_p (alpha h)^p) — 50^3 at order 8 vs 75^3 at
# order 6 for tol 1e-4 on the 30k box; every grid-sized cost (folds, FFT,
# influence) drops ~3x.
DEFAULT_ORDER = 8

# column-block width for the dense spread contraction (x columns per pass)
_COL_BLOCK = 8


def good_fft_size(n: int) -> int:
    """Smallest size >= n whose factors are all 2, 3 or 5 (fast XLA FFT)."""
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


# Measured prefactors of the PME force-error law  relF ~= C_p (alpha h)^p
# (f64 force RMSE vs converged classical Ewald on a water box).
_ERR_PREFACTOR = {4: 0.26, 6: 0.06, 8: 0.027}


def pme_grid_size(box, alpha: float, tol: float,
                  order: int = DEFAULT_ORDER) -> Tuple[int, int, int]:
    """Per-axis mesh size for a target relative force error ``tol``.

    Calibrated against measured f64 force RMSE vs the converged classical
    Ewald sum: relF ~= C_p (alpha h)^p with h the
    mesh spacing, solved for h with a 2x safety margin and rounded up to an
    FFT-friendly size.
    """
    c = 2.0 * _ERR_PREFACTOR.get(order, 0.3)
    h = (tol / c) ** (1.0 / order) / alpha
    out = []
    for L in np.asarray(box, dtype=np.float64):
        n = max(int(math.ceil(float(L) / h)), 2 * order)
        out.append(good_fft_size(n))
    return tuple(out)


def _bspline_raw(t: jax.Array, order: int, depth: int = 1):
    """Stack evaluation of the B-spline recursion
    M_n(t) = [t M_{n-1}(t) + (n - t) M_{n-1}(t - 1)] / (n - 1):
    level j holds M_n(t - j).  Returns the top ``depth`` levels (depth=2
    gives [M_p(t), M_p(t-1)] — what the derivative identity needs)."""
    level = [jnp.maximum(0.0, 1.0 - jnp.abs(t - 1.0 - j))   # M_2(t - j)
             for j in range(order - 2 + depth)]
    for n in range(3, order + 1):
        tj = [t - j for j in range(len(level) - 1)]
        level = [(tj[j] * level[j] + (n - tj[j]) * level[j + 1]) / (n - 1)
                 for j in range(len(level) - 1)]
    return level[:depth]


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def bspline(t: jax.Array, order: int) -> jax.Array:
    """Cardinal B-spline M_p(t), support (0, p).

    custom_vjp with the analytic derivative identity
    M_p'(t) = M_{p-1}(t) - M_{p-1}(t-1): one extra order-(p-1) evaluation in
    the backward instead of autodiff differentiating every level of the
    recursion stack (which saves/replays ~p^2/2 intermediates).  Exact a.e.
    (the kinks land on grid nodes, a measure-zero set).
    """
    return _bspline_raw(t, order)[0]


def _bspline_fwd(t, order):
    return _bspline_raw(t, order)[0], t


def _bspline_bwd(order, t, ct):
    lo = _bspline_raw(t, order - 1, depth=2)
    return (ct * (lo[0] - lo[1]),)


bspline.defvjp(_bspline_fwd, _bspline_bwd)


def spread_weights(u: jax.Array, grid_n: int, order: int) -> jax.Array:
    """Dense per-axis spread weights W[i, g] = M_p((u_i - g) mod G).

    ``u`` is the fractional coordinate scaled to [0, G).  The mod makes the
    periodic wrap automatic; entries outside the spline support are exactly
    zero.
    """
    g = jnp.arange(grid_n, dtype=u.dtype)
    t = u[:, None] - g[None, :]
    t = t - grid_n * jnp.floor(t / grid_n)          # (u - g) mod G in [0, G)
    return bspline(t, order)


def _bspline_dft_sq(grid_n: int, order: int) -> np.ndarray:
    """|b(m)|^2 Euler factors, numpy [G] (static, f64)."""
    j = np.arange(order - 1)

    # M_p at the integer nodes 1..p-1 via the scalar recursion
    def m_n(n, t):
        if n == 2:
            return max(0.0, 1.0 - abs(t - 1.0))
        return (t * m_n(n - 1, t) + (n - t) * m_n(n - 1, t - 1.0)) / (n - 1)
    nodes = np.array([m_n(order, float(k + 1)) for k in j])
    m = np.arange(grid_n)
    ph = np.exp(2j * np.pi * m[:, None] * j[None, :] / grid_n)
    denom = ph @ nodes
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-300)


def influence_function(grid: Tuple[int, int, int], box: jax.Array,
                       alpha: float, order: int,
                       dtype=jnp.float64) -> jax.Array:
    """Real rFFT-space influence function D [Gx, Gy, Gz//2+1] such that
    E_rec = sum(D * |Q^|^2).

    Folds in (2 pi k_e / V), the Ewald kernel, the B-spline Euler factors
    and the rFFT half-space double-count weights; origin masked to zero.
    ``box`` may be traced (it enters only through k = 2 pi m / L — cheap
    elementwise work on the G^3/2 grid).
    """
    gx, gy, gz = grid
    vol = box_volume(box)

    def ifreqs(n):
        return np.fft.fftfreq(n, d=1.0 / n)          # signed integer freqs

    two_pi = 2.0 * math.pi
    if box.ndim == 2:
        # triclinic (reduced row-vector lattice): |k|^2 = m.G.m with the
        # reciprocal Gram matrix; three cross terms on the [G^3/2] grid
        g = reciprocal_metric(box, dtype)      # includes the (2 pi)^2
        mx = jnp.asarray(ifreqs(gx), dtype)[:, None, None]
        my = jnp.asarray(ifreqs(gy), dtype)[None, :, None]
        mz = jnp.asarray(np.arange(gz // 2 + 1), dtype)[None, None, :]
        k2 = (g[0, 0] * mx * mx + g[1, 1] * my * my + g[2, 2] * mz * mz
              + 2.0 * (g[0, 1] * mx * my + g[0, 2] * mx * mz
                       + g[1, 2] * my * mz))
    else:
        kx = (two_pi * jnp.asarray(ifreqs(gx), dtype) / box[0])[:, None, None]
        ky = (two_pi * jnp.asarray(ifreqs(gy), dtype) / box[1])[None, :, None]
        kz = (two_pi * jnp.asarray(np.arange(gz // 2 + 1), dtype)
              / box[2])[None, None, :]
        k2 = kx * kx + ky * ky + kz * kz
    origin = np.zeros((gx, gy, gz // 2 + 1), dtype=bool)
    origin[0, 0, 0] = True
    k2s = jnp.where(jnp.asarray(origin), 1.0, k2)
    kern = jnp.where(jnp.asarray(origin), 0.0,
                     jnp.exp(-k2s * (0.25 / (alpha * alpha))) / k2s)

    bx = _bspline_dft_sq(gx, order)[:, None, None]
    by = _bspline_dft_sq(gy, order)[None, :, None]
    bz = _bspline_dft_sq(gz, order)[: (gz // 2 + 1)][None, None, :]

    wz = np.full(gz // 2 + 1, 2.0)
    wz[0] = 1.0
    if gz % 2 == 0:
        wz[-1] = 1.0
    static = jnp.asarray(bx * by * bz * wz[None, None, :], dtype)
    const = two_pi * ONE_4PI_EPS0 / vol
    return const * kern * static


def _spread_grid(wx, wy, wz, q, dtype):
    """Q[x, y, z] = sum_i q_i Wx[i,x] Wy[i,y] Wz[i,z] via column-blocked
    matmuls (no scatter).  wx/wy/wz: [N, G*]."""
    dot = partial(jnp.matmul, preferred_element_type=dtype,
                  precision=dot_precision(dtype))
    gx = wx.shape[1]
    cb = _COL_BLOCK
    nb = max(g for g in range(1, cb + 1) if gx % g == 0)  # divisor <= cb
    cwx = (q[:, None] * wx).T.reshape(gx // nb, nb, -1)   # [XB, nb, N]

    def one(block):
        # [nb, N] columns: (Wy * col).T @ Wz for each col in the block
        def col(c):
            return dot((wy * c[:, None]).T, wz)           # [Gy, Gz]
        return jax.vmap(col)(block)                       # [nb, Gy, Gz]

    blocks = jax.lax.map(one, cwx)                        # [XB, nb, Gy, Gz]
    return blocks.reshape(gx, wy.shape[1], wz.shape[1])


def _patch_origins(n_cells: int, grid_n: int, order: int,
                   extra: int = 0) -> np.ndarray:
    """Static grid origin of each cell's spread patch (may be negative;
    wrap handled by jnp.roll at placement).  ``extra`` extends the patch
    for neighbor-state reuse drift (spec.pme_slack)."""
    c = np.arange(n_cells)
    return (np.floor(c * grid_n / n_cells)).astype(np.int64) - order - extra


def _patch_width(n_cells: int, grid_n: int, order: int,
                 extra: int = 0) -> int:
    """Patch extent covering every support point of every atom in a cell,
    with one point of slack per side for binning/scaling rounding plus
    ``extra`` points per side for reuse drift: with frozen neighbor state
    an atom may sit up to skin/2 past its rebuild-time cell before the
    freshness guard fires, and a too-narrow patch would silently truncate
    its spline support (quietly wrong reciprocal forces, no NaN)."""
    return int(math.ceil(grid_n / n_cells)) + order + 2 + 2 * extra


def _fold_axis(parts, origins, grid_n, patch_axis, cell_axis):
    """Overlap-add a cell-indexed patch axis onto the full grid axis:
    out[..., g] = sum_{c, w} parts[..., c, ..., w, ...] [g == (origins[c]+w)
    mod G].  All placements are static, so the fold is ONE matmul against a
    0/1 placement tensor instead of 7 pad+roll copies per axis, and the
    autodiff backward is the transposed matmul."""
    n_cells = parts.shape[cell_axis]
    w = parts.shape[patch_axis]
    dtype = parts.dtype
    t = np.zeros((n_cells, w, grid_n), dtype=np.float64)
    for c in range(n_cells):
        for j in range(w):
            t[c, j, (int(origins[c]) + j) % grid_n] = 1.0
    t = jnp.asarray(t, dtype)
    # contract (cell_axis, patch_axis) against t's (0, 1); placement values
    # are exactly 0/1 so full f32 precision keeps the fold exact
    prec = None if dtype == jnp.float64 else jax.lax.Precision.HIGHEST
    out = jax.lax.dot_general(
        parts, t,
        dimension_numbers=(((cell_axis, patch_axis), (0, 1)), ((), ())),
        preferred_element_type=dtype, precision=prec)
    return out


@jax.custom_vjp
def _spread_patches(qwlx, wly, wlz):
    """Per-cell patch contraction P[c,x,y,z] = sum_a qwlx[c,a,x] wly[c,a,y]
    wlz[c,a,z] with a hand-written VJP: autodiff of the two-step product +
    einsum materializes the [C, cap, Wx*Wy] intermediate several times; the
    hand backward computes the three cotangents with one batched matmul
    each plus two fused multiply-reduce passes."""
    return _spread_patches_fwd(qwlx, wly, wlz)[0]


def _spread_patches_fwd(qwlx, wly, wlz):
    c, cap, wx = qwlx.shape
    wy = wly.shape[-1]
    dtype = qwlx.dtype
    a = (qwlx[..., :, None] * wly[..., None, :]).reshape(c, cap, wx * wy)
    p = jnp.einsum("caw,caz->cwz", a, wlz, preferred_element_type=dtype,
                   precision=dot_precision(dtype))
    return p.reshape(c, wx, wy, wlz.shape[-1]), (qwlx, wly, wlz)


def _spread_patches_bwd(res, ct):
    qwlx, wly, wlz = res
    c, cap, wx = qwlx.shape
    wy = wly.shape[-1]
    wz = wlz.shape[-1]
    dtype = qwlx.dtype
    prec = dot_precision(dtype)
    dp = ct.reshape(c, wx * wy, wz)
    # B[c,a,(x,y)] = sum_z dP wlz — one batched matmul
    b = jnp.einsum("cwz,caz->caw", dp, wlz, preferred_element_type=dtype,
                   precision=prec).reshape(c, cap, wx, wy)
    d_qwlx = jnp.sum(b * wly[..., None, :], axis=-1)
    d_wly = jnp.sum(b * qwlx[..., :, None], axis=-2)
    # dwlz needs `a`; recompute it (one cheap product pass)
    a = (qwlx[..., :, None] * wly[..., None, :]).reshape(c, cap, wx * wy)
    d_wlz = jnp.einsum("caw,cwz->caz", a, dp, preferred_element_type=dtype,
                       precision=prec)
    return d_qwlx, d_wly, d_wlz


_spread_patches.defvjp(_spread_patches_fwd, _spread_patches_bwd)


def _cell_patch_weights(coord, n_cells, grid_n, length, extra, cell_axis,
                        order, dtype):
    """Per-cell compact B-spline patch weights — the ONE constructor
    behind the cell-blocked spread routes (pme_cell_reciprocal_energy and
    the halo local mesh); the two must stay bit-identical for the routes
    to agree to reduction-order rounding.  Returns (weights [.., cap, W],
    int patch origins [n_cells], patch width)."""
    u = coord * (grid_n / length)
    org = _patch_origins(n_cells, grid_n, order, extra)
    w = _patch_width(n_cells, grid_n, order, extra)
    shape = [1, 1, 1, 1, 1]
    shape[cell_axis] = n_cells
    base = jnp.asarray(org, dtype).reshape(shape)
    j = jnp.arange(w, dtype=dtype).reshape(1, 1, 1, 1, w)
    t = u[..., None] - (base + j)
    return bspline(t, order), org, w


def _block_spread_coords(blocks, box):
    """Per-axis spread coordinates for the cell-blocked routes, as three
    (coord, length) pairs with u_axis = coord * (G_axis / length).

    Orthorhombic: the Cartesian block coordinates against the edge lengths
    (bit-identical to the historical path).  Triclinic: the B-spline mesh
    lives on the unit cell, so the coordinates are fractional —
    lower-triangular back-substitution f = x @ B^-1 on the block arrays
    (cheap elementwise combinations) — against length 1."""
    if box.ndim == 2:
        inv = box_inverse(box)
        fx = blocks.x * inv[0, 0] + blocks.y * inv[1, 0] + blocks.z * inv[2, 0]
        fy = blocks.y * inv[1, 1] + blocks.z * inv[2, 1]
        fz = blocks.z * inv[2, 2]
        return (fx, 1.0), (fy, 1.0), (fz, 1.0)
    return ((blocks.x, box[0]), (blocks.y, box[1]), (blocks.z, box[2]))


def pme_cell_reciprocal_energy(blocks, ids, system) -> jax.Array:
    """SPME reciprocal energy spread from the shared cell-major blocks.

    The dense-separable spread (:func:`pme_reciprocal_energy`) streams
    [N, G] weight matrices through device memory per grid column.  Here
    atoms are already binned into direct-space cells
    (cells.blockify — gather shared with the direct walk, so this path adds
    ZERO gathers/scatters): each cell's atoms can only touch a static
    [W, W, W] patch of the mesh (W = ceil(G/cells) + order + 2), so the
    spread is per-cell compact weights + one batched [Wx*Wy, cap] @
    [cap, Wz] matmul + a static roll/pad overlap-add onto the grid.  All
    shapes static, no scatter anywhere, backward is matmuls + slices.
    """
    spec = system.spec
    dtype = blocks.x.dtype
    box = system.box
    alpha = spec.alpha
    grid = spec.pme_grid
    order = spec.pme_order
    ngx, ngy, ngz = spec.cell_grid
    cap = blocks.x.shape[-1]
    gx, gy, gz = grid

    n = system.n_atoms
    qv = jnp.where(ids < n, blocks.q, 0.0)

    def axis_weights(coord, n_cells, grid_n, length, cell_axis):
        return _cell_patch_weights(coord, n_cells, grid_n, length,
                                   spec.pme_slack[cell_axis], cell_axis,
                                   order, dtype)

    (cx_, lx), (cy_, ly), (cz_, lz) = _block_spread_coords(blocks, box)
    wlx, orx, wx = axis_weights(cx_, ngx, gx, lx, 0)
    wly, ory, wy = axis_weights(cy_, ngy, gy, ly, 1)
    wlz, orz, wz = axis_weights(cz_, ngz, gz, lz, 2)

    nc = ngx * ngy * ngz
    qwlx = (qv[..., None] * wlx).reshape(nc, cap, wx)
    patches = _spread_patches(qwlx, wly.reshape(nc, cap, wy),
                              wlz.reshape(nc, cap, wz))
    patches = patches.reshape(ngx, ngy, ngz, wx, wy, wz)

    # overlap-add: fold z, then y, then x.  Each fold appends its grid axis
    # last, so the result lands as [Gz, Gy, Gx] — transpose back (0.5 MB).
    b = _fold_axis(patches, orz, gz, patch_axis=5, cell_axis=2)
    b = _fold_axis(b, ory, gy, patch_axis=3, cell_axis=1)
    qgrid = jnp.transpose(_fold_axis(b, orx, gx, patch_axis=1, cell_axis=0),
                          (2, 1, 0))

    qhat = jnp.fft.rfftn(qgrid)
    d = influence_function(grid, box, alpha, order, dtype)
    return jnp.sum(d * (qhat.real * qhat.real + qhat.imag * qhat.imag))


def _pad_to_cell_multiple(grid_n: int, n_cells: int) -> int:
    """Smallest mesh extent >= grid_n divisible by n_cells, preferring the
    first 5-smooth multiple within +25% (fast XLA FFT; a finer mesh only
    reduces PME error, never accuracy)."""
    gm = -(-grid_n // n_cells) * n_cells
    cand = gm
    while cand <= gm + (gm + 3) // 4:
        if good_fft_size(cand) == cand:
            return cand
        cand += n_cells
    return gm


def pme_halo_mesh(spec, pad_y: bool = False) -> Tuple[int, int, int]:
    """SPME mesh for the halo-sharded route (parallel/halo.py).

    The x extent is padded up to a multiple of cell_grid[0] so the per-cell
    patch origins along x become a uniform static pattern (c * stride) plus
    ONE dynamic per-device slab offset — each device can then spread its
    local cells with static shapes and rotate its partial mesh into place
    with a single jnp.roll.  With ``pad_y`` (the 2-D x-by-y halo
    decomposition) y gets the same treatment; otherwise y keeps the
    single-chip mesh, and z always does (their fold placements are global
    statics, identical on every device).  When a cell-grid axis has a
    factor outside {2,3,5} (e.g. the 100k config's 11) no multiple can be
    5-smooth and the smallest one stands.
    """
    gmx = _pad_to_cell_multiple(spec.pme_grid[0], spec.cell_grid[0])
    gmy = (_pad_to_cell_multiple(spec.pme_grid[1], spec.cell_grid[1])
           if pad_y else spec.pme_grid[1])
    return (gmx, gmy, spec.pme_grid[2])


def pme_halo_local_mesh(g8, ids, system, dev,
                        mesh_grid: Tuple[int, int, int],
                        dev_y=None) -> jax.Array:
    """Partial SPME charge mesh Q_dev [Gx, Gy, Gz] from ONE device's slab
    blocks (the halo route's g8 layout: x|y|z|q|hs|se|valid|0 with wrapped
    coordinates).  ``jax.lax.psum`` over the mesh axis gives the full
    charge grid — the distributed spread is one 2-4 MB collective, after
    which every device evaluates the (cheap, replicated) FFT + influence
    contraction.  Replaces the halo route's classical O(N*K) structure-
    factor sum with the same O(N + G^3 log G) algorithm the single-chip
    production path uses (reference equivalent: the brute-force reciprocal
    loops, PBCForce.cu:841-950, which are not distributed at all).

    Requires ``mesh_grid`` from :func:`pme_halo_mesh` (x divisible by the
    cell grid).  For the 2-D x-by-y halo decomposition (g8 holds gy/Dy
    local y columns) pass the device's y index as ``dev_y`` and a
    ``pme_halo_mesh(spec, pad_y=True)`` mesh — y then gets the same
    dynamic-slab-offset + local-fold + roll treatment as x.  Spread
    weights, patch contraction and fold placements are shared with
    :func:`pme_cell_reciprocal_energy`, so on a matching mesh the two
    routes agree to reduction-order rounding.
    """
    spec = system.spec
    dtype = g8.dtype
    box = system.box
    order = spec.pme_order
    gxl, ngy, ngz, cap, _ = g8.shape
    gmx, gmy, gmz = mesh_grid
    ngx = spec.cell_grid[0]
    stride = gmx // ngx
    if stride * ngx != gmx:
        raise ValueError(f"mesh x {gmx} not divisible by cell grid {ngx}")
    local_y = ngy != spec.cell_grid[1]
    if local_y:
        stride_y = gmy // spec.cell_grid[1]
        if stride_y * spec.cell_grid[1] != gmy or dev_y is None:
            raise ValueError(
                "2-D halo spread needs pme_halo_mesh(spec, pad_y=True) "
                "and the device y index")
    n = system.n_atoms
    qv = jnp.where(ids < n, g8[..., 3], 0.0)
    ex, ey, ez = spec.pme_slack

    # spread coordinates: Cartesian/edge-lengths for orthorhombic;
    # fractional/unit for triclinic (same convention as
    # _block_spread_coords — the g8 layout carries Cartesian wrapped
    # coordinates either way)
    if box.ndim == 2:
        inv = box_inverse(box)
        cx_ = (g8[..., 0] * inv[0, 0] + g8[..., 1] * inv[1, 0]
               + g8[..., 2] * inv[2, 0])
        cy_ = g8[..., 1] * inv[1, 1] + g8[..., 2] * inv[2, 1]
        cz_ = g8[..., 2] * inv[2, 2]
        lx = ly = lz = 1.0
    else:
        cx_, cy_, cz_ = g8[..., 0], g8[..., 1], g8[..., 2]
        lx, ly, lz = box[0], box[1], box[2]

    # x: uniform local origins (c * stride - order - ex) + one dynamic slab
    # offset folded into the spline argument
    wx = stride + order + 2 + 2 * ex
    ux = cx_ * (gmx / lx)
    base = (dev * (gxl * stride)).astype(dtype)
    orgx = np.arange(gxl) * stride - order - ex
    tx = ux[..., None] - (base
                          + jnp.asarray(orgx, dtype).reshape(gxl, 1, 1, 1, 1)
                          + jnp.arange(wx, dtype=dtype))
    wlx = bspline(tx, order)

    def yz_weights(coord, n_cells, grid_n, length, extra, cell_axis):
        return _cell_patch_weights(coord, n_cells, grid_n, length, extra,
                                   cell_axis, order, dtype)

    if local_y:
        # y: same dynamic-offset form as x (2-D decomposition)
        wy = stride_y + order + 2 + 2 * ey
        uy = cy_ * (gmy / ly)
        base_y = (dev_y * (ngy * stride_y)).astype(dtype)
        orgy_rel = np.arange(ngy) * stride_y - order - ey
        ty = uy[..., None] - (base_y
                              + jnp.asarray(orgy_rel, dtype).reshape(
                                  1, ngy, 1, 1, 1)
                              + jnp.arange(wy, dtype=dtype))
        wly = bspline(ty, order)
    else:
        wly, orgy, wy = yz_weights(cy_, ngy, gmy, ly, ey, 1)
    wlz, orgz, wz = yz_weights(cz_, ngz, gmz, lz, ez, 2)

    nc = gxl * ngy * ngz
    qwlx = (qv[..., None] * wlx).reshape(nc, cap, wx)
    patches = _spread_patches(qwlx, wly.reshape(nc, cap, wy),
                              wlz.reshape(nc, cap, wz))
    patches = patches.reshape(gxl, ngy, ngz, wx, wy, wz)

    b = _fold_axis(patches, orgz, gmz, patch_axis=5, cell_axis=2)
    if local_y:
        py = (ngy - 1) * stride_y + wy
        rel_y = np.arange(ngy) * stride_y
        b = _fold_axis(b, rel_y, py, patch_axis=3, cell_axis=1)
    else:
        b = _fold_axis(b, orgy, gmy, patch_axis=3, cell_axis=1)
    # x fold onto a LOCAL extent with relative origins (c * stride >= 0,
    # never wraps), then wrap-fold onto the mesh and rotate into place
    px = (gxl - 1) * stride + wx
    rel = np.arange(gxl) * stride
    loc = jnp.transpose(_fold_axis(b, rel, px, patch_axis=1, cell_axis=0),
                        (2, 1, 0))                       # [Px, Py|Gy, Gz]
    out = jnp.zeros((gmx, loc.shape[1], gmz), dtype)
    for k0 in range(0, px, gmx):
        seg = jax.lax.slice_in_dim(loc, k0, min(k0 + gmx, px), axis=0)
        out = out + jnp.pad(seg, ((0, gmx - seg.shape[0]), (0, 0), (0, 0)))
    out = jnp.roll(out, dev * (gxl * stride) - (order + ex), axis=0)
    if local_y:
        outy = jnp.zeros((gmx, gmy, gmz), dtype)
        for k0 in range(0, py, gmy):
            seg = jax.lax.slice_in_dim(out, k0, min(k0 + gmy, py), axis=1)
            outy = outy + jnp.pad(
                seg, ((0, 0), (0, gmy - seg.shape[1]), (0, 0)))
        out = jnp.roll(outy, dev_y * (ngy * stride_y) - (order + ey),
                       axis=1)
    return out


def pme_reciprocal_energy(positions: jax.Array, q: jax.Array, box: jax.Array,
                          alpha: float, grid: Tuple[int, int, int],
                          order: int = DEFAULT_ORDER) -> jax.Array:
    """SPME reciprocal-space energy; forces/dedq come from jax.grad.

    Drop-in replacement for ewald.reciprocal_energy (same Ewald splitting
    alpha, same self/direct/exclusion companions) with O(N + G^3 log G)
    cost and accuracy set by (grid, order) — see pme_grid_size.
    """
    dtype = positions.dtype
    gx, gy, gz = grid
    # fractional coordinates: the B-spline spread lives on the unit-cell
    # mesh for any lattice, so the dense route serves triclinic boxes too
    frac = frac_coords(positions, box)
    frac = frac - jax.lax.stop_gradient(jnp.floor(frac))
    u = frac * jnp.asarray(np.asarray(grid), dtype)

    wx = spread_weights(u[:, 0], gx, order)
    wy = spread_weights(u[:, 1], gy, order)
    wz = spread_weights(u[:, 2], gz, order)

    qgrid = _spread_grid(wx, wy, wz, q.astype(dtype), dtype)
    qhat = jnp.fft.rfftn(qgrid)
    d = influence_function(grid, box, alpha, order, dtype)
    return jnp.sum(d * (qhat.real * qhat.real + qhat.imag * qhat.imag))
