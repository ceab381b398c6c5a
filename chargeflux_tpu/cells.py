"""Fixed-capacity cell list for the periodic direct-space sum.

Replaces the reference's runtime neighbor-list services — the CPU voxel hash
rebuilt every step (ReferenceCoulKernels.cpp:559) and OpenMM's CUDA
tile/interacting-blocks machinery (CudaCoulKernels.cpp:422;
PBCForce.cu:86-751) — with a static-shape scheme inside the jit program:

* static cell grid (>= 3 cells per axis, cell edge >= cutoff) baked into the
  trace (system.spec.cell_grid/capacity);
* atoms binned by one-hot rank, scattered into a dense [n_cells, capacity]
  slot array (sentinel = N for empty slots) — static shapes, rebuilt
  *inside* the jit program;
* **half-shell** traversal: the self shift with i<j plus 13 lexicographically
  positive neighbor shifts — every pair visited exactly once (the cell
  analog of the CUDA warp-tile diagonal scheme, PBCForce.cu:24-62);
* static image offsets: positions are wrapped into the box, and for each
  (cell, shift) the periodic image offset is a *static* table entry, so the
  minimum image needs no per-pair floor();
* erfc via the fast f32 polynomial (ops/erfc.py) on the production path.

Like the CUDA path (USE_EXCLUSIONS disabled, CudaCoulKernels.cpp:484), the
kernel computes erfc+LJ for *all* in-range pairs including excluded ones;
energy.py's exclusion correction subtracts them to land on the contract.

Triclinic boxes (extension; the reference is orthorhombic-only,
ReferenceCoulKernels.cpp:513-517): binning is fractional (f = x @ B^-1),
the grid is sized against the lattice's perpendicular plane widths
(system.py), and a boundary wrap along grid axis ``a`` contributes the full
lattice row ``+-B[a]`` to the static image offsets
(:func:`shift_image_offsets`).  With cell plane spacing >= cutoff the same
half-shell walk covers every in-range pair exactly once at its unique
minimum image (|any nonzero lattice combination| >= min plane width
>= 2 rc).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .ops.erfc import erf_over_r_eval, erfc_fast
from .pairs import frac_coords, lattice_cart
from .units import ONE_4PI_EPS0

# Half-shell shift set: (0,0,0) self + 13 lexicographically positive shifts.
HALF_SHELL = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
]
assert len(HALF_SHELL) == 14



def _boundary_crossing(axis_len: int, d: int) -> np.ndarray:
    """Static per-cell wrap indicator along one grid axis: +1 where a roll
    by ``d`` crosses the high boundary, -1 across the low one, 0 inside
    (trace-time NumPy [axis_len])."""
    c = np.arange(axis_len)
    return np.where(c + d >= axis_len, 1.0, np.where(c + d < 0, -1.0, 0.0))


def boundary_image_offset(axis_len: int, d: int, box_len, dtype):
    """Static per-cell periodic image offset along one grid axis:
    ``+-box_len`` where a roll by ``d`` wraps, 0 inside (the ONE copy shared
    by the roll walk, the concat tile, the explicit-shift builder and the
    halo route)."""
    return jnp.asarray(_boundary_crossing(axis_len, d), dtype) * box_len


def shift_image_offsets(grid, shift, box, dtype):
    """Cartesian image offsets of the j-slab for a half-shell ``shift``,
    as three arrays (one per coordinate) broadcastable to [gx, gy, gz, 1].

    Orthorhombic ([3] box): coordinate k shifts only where the roll wraps
    along axis k — the classic per-axis ``+-L_k`` column.  Triclinic
    ([3, 3] reduced row-vector lattice): wrapping along grid axis ``a``
    adds the full lattice row ``+-B[a]``, so coordinate k collects the
    crossings of every axis ``a >= k`` (lower-triangular) scaled by the
    traced ``B[a, k]``."""
    gx, gy, gz = grid
    dx, dy, dz = shift
    if box.ndim == 2:
        cx = jnp.asarray(_boundary_crossing(gx, dx), dtype).reshape(
            gx, 1, 1, 1)
        cy = jnp.asarray(_boundary_crossing(gy, dy), dtype).reshape(
            1, gy, 1, 1)
        cz = jnp.asarray(_boundary_crossing(gz, dz), dtype).reshape(
            1, 1, gz, 1)
        return (cx * box[0, 0] + cy * box[1, 0] + cz * box[2, 0],
                cy * box[1, 1] + cz * box[2, 1],
                cz * box[2, 2])
    return (boundary_image_offset(gx, dx, box[0], dtype).reshape(gx, 1, 1, 1),
            boundary_image_offset(gy, dy, box[1], dtype).reshape(1, gy, 1, 1),
            boundary_image_offset(gz, dz, box[2], dtype).reshape(1, 1, gz, 1))


def wrap_offsets(positions: jax.Array, box: jax.Array) -> jax.Array:
    """Lattice translation [N, 3] that wraps each position into the primary
    cell (``positions - wrap_offsets`` has fractional coordinates in
    [0, 1)).  ``box * floor(x / box)`` for an orthorhombic [3] box;
    ``floor(f) @ B`` for a [3, 3] lattice (elementwise-expanded — see
    pairs.frac_coords' f32 matmul precision note)."""
    if box.ndim == 2:
        return lattice_cart(jnp.floor(frac_coords(positions, box)), box)
    return box * jnp.floor(positions / box)


def neighbor_cell_table(grid) -> np.ndarray:
    """Static [n_cells, 27] table of wrapped neighbor cell ids (full shell;
    used by tests and diagnostics)."""
    gx, gy, gz = grid
    ids = np.arange(gx * gy * gz)
    cx, cy, cz = ids // (gy * gz), (ids // gz) % gy, ids % gz
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                out.append((((cx + dx) % gx) * gy + (cy + dy) % gy) * gz
                           + (cz + dz) % gz)
    return np.stack(out, axis=1).astype(np.int32)


def half_shell_tables(grid):
    """Static tables for the half-shell traversal.

    Returns (nbr_ids [C, 14] int32, image_offsets [C, 14, 3] int8): for cell
    c and shift s, the neighbor cell id and the periodic image offset (in box
    units) of that neighbor relative to c.  Shift 0 is the self cell.
    """
    gx, gy, gz = grid
    ids = np.arange(gx * gy * gz)
    cx, cy, cz = ids // (gy * gz), (ids // gz) % gy, ids % gz
    nbr, off = [], []
    for (dx, dy, dz) in HALF_SHELL:
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        nbr.append(((nx % gx) * gy + ny % gy) * gz + nz % gz)
        off.append(np.stack([nx // gx, ny // gy, nz // gz], axis=-1))
    return (np.stack(nbr, axis=1).astype(np.int32),
            np.stack(off, axis=1).astype(np.int8))


def rank_into_slots(col, cz, owned, n, ncol, gz, capacity):
    """Shared masked ranking core: place atom i (column index ``col[i]`` of
    ``ncol`` (x, y)-columns, z-cell ``cz[i]`` of ``gz``) into fixed-capacity
    cell slots.  ``owned`` masks atoms to bin (the halo path excludes atoms
    owned by other devices); the single-chip path passes all-True.

    Returns (slots [ncol*gz, capacity] int32 atom ids, sentinel n;
    slot_of [N] int32 flat slot per atom, sentinel ncol*gz*capacity;
    overflow — count of OWNED atoms dropped; the energy path NaN-poisons
    when it is nonzero).
    """
    n_cells = ncol * gz
    sentinel = n_cells * capacity
    kz = 1 << max(int(gz - 1).bit_length(), 1)
    # Gate ALL the two-stage intermediates, not just the stage-A one-hot:
    # stage B allocates [ncol, gz*cap, gz] (elongated needle boxes blow
    # this up while n*ncol stays small), and the packed (atom id, cz)
    # staging needs n*kz to fit int32.
    two_stage_ok = (n * ncol <= 256_000_000
                    and n_cells * capacity * gz <= 256_000_000
                    and n * kz < 2 ** 31)
    if two_stage_ok:
        # Two-stage hierarchical one-hot ranking (rank = count of same-cell
        # atoms before you, computed without sorts or rank gathers):
        #   A) rank atoms within their (cx, cy) COLUMN via a [N, ncol]
        #      one-hot cumsum and stage them column-major (one scatter);
        #   B) rank within z-cells on the staged layout via a
        #      [ncol, gz*cap, gz] one-hot cumsum.
        # Cuts the one-hot work from O(N * n_cells) to O(N * ncol +
        # n_slots * gz) against the flat [N, n_cells] one-hot.  Slot
        # layout is identical.  (A device sort is the other way to rank;
        # which is faster on the card awaits an A/B.)
        scap = gz * capacity
        onehot_a = ((col[:, None] == jnp.arange(ncol)[None, :])
                    & owned[:, None]).astype(jnp.int32)
        cum_a = jnp.cumsum(onehot_a, axis=0)
        rank_a = jnp.sum(onehot_a * cum_a, axis=1) - 1    # no rank gather
        ok_a = owned & (rank_a < scap) & (rank_a >= 0)
        colslot = jnp.where(ok_a, col * scap + rank_a, ncol * scap)

        # stage (atom id, cz) packed into one int32 — unpacking is
        # elementwise, where a separate cz fetch would be a scalar gather
        packed = jnp.arange(n, dtype=jnp.int32) * kz + cz
        staged = jnp.full((ncol * scap,), n * kz, jnp.int32)
        staged = staged.at[colslot].set(packed, mode="drop")
        sid = staged // kz
        scz = (staged % kz).reshape(ncol, scap)
        valid = (sid < n).reshape(ncol, scap)

        onehot_b = ((scz[:, :, None] == jnp.arange(gz)[None, None, :])
                    & valid[:, :, None]).astype(jnp.int32)
        cum_b = jnp.cumsum(onehot_b, axis=1)
        rank_b = jnp.sum(onehot_b * cum_b, axis=2) - 1    # [ncol, scap]

        cell_flat = (jnp.arange(ncol, dtype=jnp.int32)[:, None] * gz + scz)
        ok_b = valid & (rank_b < capacity)
        slot_of_flat = jnp.where(ok_b, cell_flat * capacity + rank_b,
                                 sentinel).astype(jnp.int32)

        slots = jnp.full((sentinel,), n, jnp.int32)
        slots = slots.at[slot_of_flat.ravel()].set(sid.reshape(-1),
                                                   mode="drop")
        slot_of = jnp.full((n,), sentinel, jnp.int32)
        slot_of = slot_of.at[sid.reshape(-1)].set(slot_of_flat.ravel(),
                                                  mode="drop")
        # counts OWNED atoms dropped at either stage; nonzero iff some
        # cell genuinely exceeds capacity (a column can only overflow
        # gz*cap when at least one of its cells overflows cap).  Under
        # heavy overflow the *retained subset* may differ from pure
        # per-cell ranking (stage A drops by column rank) — irrelevant
        # because the energy path NaN-poisons whenever this is nonzero.
        overflow = (jnp.sum(owned & ~ok_a)
                    + jnp.sum(valid & (rank_b >= capacity))).astype(jnp.int32)
    else:
        # Huge systems: sort-based binning (O(N log N), O(N) memory).
        cell_id = jnp.where(owned, col * gz + cz, n_cells)
        order = jnp.argsort(cell_id)
        sorted_cid = cell_id[order]
        first = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
        rank = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
        in_range = sorted_cid < n_cells
        ok = in_range & (rank < capacity)
        atom_ids = order.astype(jnp.int32)
        slot_of = jnp.where(ok, sorted_cid * capacity + rank,
                            sentinel).astype(jnp.int32)
        slots = jnp.full((sentinel,), n, dtype=jnp.int32)
        slots = slots.at[slot_of].set(atom_ids, mode="drop")
        overflow = jnp.sum(in_range & ~ok).astype(jnp.int32)
        slot_of = jnp.full((n,), sentinel, jnp.int32).at[atom_ids].set(
            slot_of, mode="drop")
    return slots.reshape(n_cells, capacity), slot_of, overflow


@partial(jax.jit, static_argnums=(2, 3))
def build_cell_list_full(positions: jax.Array, box: jax.Array, grid,
                         capacity: int):
    """Bin atoms into cells.  Returns (slots, inv_slot, overflow):

    * slots [n_cells, capacity] int32 — slot -> atom id, sentinel N empty;
    * inv_slot [N] int32 — atom -> flat slot index, sentinel n_cells*capacity
      for atoms dropped by overflow.  The inverse permutation turns the
      backward pass of the block gather into another (fast, row-wise)
      gather instead of a scatter;
    * overflow [scalar int32] — count of dropped atoms; the energy path
      poisons the result to NaN when nonzero.
    """
    n = positions.shape[0]
    gvec = jnp.asarray(np.asarray(grid), dtype=positions.dtype)
    frac = frac_coords(positions, box)
    frac = frac - jnp.floor(frac)
    ci = jnp.clip((frac * gvec).astype(jnp.int32), 0,
                  jnp.asarray(np.asarray(grid) - 1, dtype=jnp.int32))
    gx, gy, gz = grid
    col = ci[:, 0] * gy + ci[:, 1]
    owned = jnp.ones((n,), bool)
    return rank_into_slots(col, ci[:, 2], owned, n, gx * gy, gz, capacity)


@partial(jax.jit, static_argnums=(2, 3))
def build_cell_list(positions: jax.Array, box: jax.Array, grid, capacity: int):
    """Bin atoms into cells.  Returns (slots [n_cells, capacity] int32 with
    sentinel N for empty, overflow count [scalar int32]).

    Overflow (more atoms in a cell than capacity) drops atoms; callers must
    check the returned count (see :func:`validate_cell_list`).
    """
    slots, _, overflow = build_cell_list_full(positions, box, grid, capacity)
    return slots, overflow


def suggest_capacity(positions, box, grid, margin: float = 1.25,
                     multiple: int = 8) -> int:
    """Capacity from an actual configuration: max cell occupancy * margin,
    rounded up to ``multiple``.  The create_system default (4-sigma Poisson
    headroom) underestimates clumpy configurations — e.g. lattice initial
    conditions aliasing against the cell grid; the in-jit overflow guard
    turns that into a visible NaN, and this helper is the remedy."""
    positions = np.asarray(positions, dtype=np.float64)
    box = np.asarray(box, dtype=np.float64)
    grid = np.asarray(grid)
    frac = positions @ np.linalg.inv(box) if box.ndim == 2 else positions / box
    frac -= np.floor(frac)
    ci = np.clip((frac * grid).astype(np.int64), 0, grid - 1)
    cid = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    peak = int(np.bincount(cid, minlength=int(np.prod(grid))).max())
    cap = int(math.ceil(peak * margin))
    return ((cap + multiple - 1) // multiple) * multiple


def validate_cell_list(positions, system) -> int:
    """Host-side overflow check; returns the dropped-atom count (should be 0,
    otherwise rebuild the system with a larger cell_capacity)."""
    spec = system.spec
    _, overflow = build_cell_list(positions, system.box, spec.cell_grid,
                                  spec.cell_capacity)
    return int(overflow)


def _pair_block_energy(pos_i, ni, q_i, hs_i, se_i, mask_i,
                       pos_j, q_j, hs_j, se_j, mask_j,
                       alpha, cutoff2, extra_mask=None):
    """Masked pair energy between an i-block [C, cap, 3] and a j-block
    [C, cap, 3] of cell-centered coordinates.

    r^2 is accumulated per component as broadcast elementwise arithmetic
    — a K=3 contraction gains nothing from a matrix unit, and componentwise
    XLA fuses the subtract/square/add chain without materializing a
    [C, cap, cap, 3] tensor.  (ni is accepted for API symmetry but recomputed implicitly.)"""
    del ni
    r2 = 0.0
    for k in range(3):
        dk = pos_i[:, :, None, k] - pos_j[:, None, :, k]
        r2 = r2 + dk * dk
    mask = mask_i[:, :, None] & mask_j[:, None, :] & (r2 < cutoff2)
    if extra_mask is not None:
        mask = mask & extra_mask
    r2s = jnp.where(mask, r2, 1.0)
    inv_r = jax.lax.rsqrt(r2s)
    qq = q_i[:, :, None] * q_j[:, None, :]
    if r2.dtype == jnp.float64:
        coul = ONE_4PI_EPS0 * qq * inv_r * erfc_fast(alpha * (r2s * inv_r))
    else:
        # erfc(ar)/r = 1/r - P(r^2): no exp, no divide (ops/erfc.py)
        cut2 = cutoff2 if isinstance(cutoff2, float) else float(cutoff2)
        coul = ONE_4PI_EPS0 * qq * (
            inv_r - erf_over_r_eval(r2s, float(alpha), math.sqrt(cut2)))
    sig2 = ((hs_i[:, :, None] + hs_j[:, None, :]) * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    lj = (se_i[:, :, None] * se_j[:, None, :]) * sig6 * (sig6 - 1.0)
    return jnp.sum(jnp.where(mask, coul + lj, 0.0))


def cell_rows_direct_energy(positions, q, system, slots, nbr_ids, offsets,
                            row_start, n_rows):
    """Direct-space energy for cell rows [row_start, row_start + n_rows).

    ``slots`` is the full [C, cap] binning (neighbor lookups need all cells);
    ``nbr_ids``/``offsets`` are the (possibly padded) half-shell tables as
    jnp arrays [C_pad, 14] / [C_pad, 14, 3]; ``row_start`` may be traced
    (sharded chunking), ``n_rows`` must be static.
    """
    spec = system.spec
    n = positions.shape[0]
    dtype = positions.dtype
    box = system.box
    grid = np.asarray(spec.cell_grid)

    # Wrap once; per-(cell,shift) image offsets handle the rest statically.
    pos_w = positions - wrap_offsets(positions, box)

    pad = lambda a, fill: jnp.concatenate(
        [a, jnp.full((1,) + a.shape[1:], fill, a.dtype)], axis=0)
    pos_p = pad(pos_w, 0.0)
    q_p = pad(q, 0.0)
    hs_p = pad(0.5 * system.sigma.astype(dtype), 0.0)
    se_p = pad(2.0 * jnp.sqrt(system.epsilon.astype(dtype)), 0.0)

    # Cell centers of the *row* cells, for f32-friendly centered coordinates.
    c_pad = nbr_ids.shape[0]
    ids = np.arange(c_pad)
    coords = np.stack([np.minimum(ids // (grid[1] * grid[2]), grid[0] - 1),
                       (ids // grid[2]) % grid[1],
                       ids % grid[2]], axis=-1)
    centers_frac = ((jnp.asarray(coords, dtype) + 0.5)
                    / jnp.asarray(grid, dtype))
    centers_all = lattice_cart(centers_frac, box)

    my_slots = jax.lax.dynamic_slice_in_dim(
        jnp.concatenate([slots, jnp.full((c_pad - slots.shape[0],
                                          slots.shape[1]), n, jnp.int32)],
                        axis=0) if c_pad > slots.shape[0] else slots,
        row_start, n_rows, axis=0)
    my_nbrs = jax.lax.dynamic_slice_in_dim(nbr_ids, row_start, n_rows, axis=0)
    my_offs = jax.lax.dynamic_slice_in_dim(offsets, row_start, n_rows, axis=0)
    centers = jax.lax.dynamic_slice_in_dim(centers_all, row_start, n_rows, axis=0)

    pos_i = pos_p[my_slots] - centers[:, None, :]
    ni = jnp.sum(pos_i * pos_i, axis=-1)
    q_i = q_p[my_slots]
    hs_i = hs_p[my_slots]
    se_i = se_p[my_slots]
    mask_i = my_slots < n

    alpha = spec.alpha
    cutoff2 = spec.cutoff * spec.cutoff

    # --- self cell (shift 0): i < j by global atom id, no image offset.
    same = my_slots[:, :, None] < my_slots[:, None, :]
    e_self_cells = _pair_block_energy(
        pos_i, ni, q_i, hs_i, se_i, mask_i,
        pos_i, q_i, hs_i, se_i, mask_i,
        alpha, cutoff2, extra_mask=same)

    # --- 13 half-shell neighbor shifts: all (i, j) ordered pairs once.
    offs_f = my_offs.astype(dtype)                      # [rows, 14, 3]

    def shift_energy(carry, s_idx):
        j_cell = my_nbrs[:, s_idx]                      # [rows]
        j_slot = slots[j_cell]                          # [rows, cap]
        shift = lattice_cart(offs_f[:, s_idx, :], box)  # [rows, 3]
        pos_j = pos_p[j_slot] + shift[:, None, :] - centers[:, None, :]
        e = _pair_block_energy(
            pos_i, ni, q_i, hs_i, se_i, mask_i,
            pos_j, q_p[j_slot], hs_p[j_slot], se_p[j_slot], j_slot < n,
            alpha, cutoff2)
        return carry + e, None

    total, _ = jax.lax.scan(jax.checkpoint(shift_energy), e_self_cells,
                            jnp.arange(1, 14))
    return total


class CellBlocks(NamedTuple):
    """Differentiable cell-major block arrays, all [gx, gy, gz, cap].

    ``x/y/z`` are box-wrapped absolute coordinates; ``q`` effective charges;
    ``hs`` half-sigma and ``se`` 2*sqrt(eps) LJ prefactors.  Empty slots hold
    zeros.  Produced by :func:`blockify` — the ONE gather (and, in the
    backward pass, the ONE scatter) of the cell route, shared by the direct
    walk and the cell-blocked PME spread.
    """

    x: jax.Array
    y: jax.Array
    z: jax.Array
    q: jax.Array
    hs: jax.Array
    se: jax.Array



@jax.custom_vjp
def gather_rows(table, flat, inv):
    """Row gather with an inverse-permutation backward.

    ``table`` [R, C] (last row a zero pad), ``flat`` [S] row indices
    (sentinel R-1 allowed), ``inv`` [R-1] the inverse mapping (row -> output
    position, sentinel >= S for rows that appear nowhere).  Forward is one
    row gather; backward gathers cotangent rows by ``inv`` instead of
    scatter-adding (valid because flat is a permutation: a gather where a
    scatter-add would otherwise accumulate).  Defined at module level with the index arrays as explicit
    arguments (float0 cotangents): a custom_vjp whose fwd/bwd close over
    forward-trace tracers breaks under the shard_map transpose.
    """
    return table[flat]


def _gather_rows_fwd(table, flat, inv):
    return table[flat], (inv, table.shape[0])


def _gather_rows_bwd(res, ct):
    inv, nrow = res
    ctp = jnp.concatenate([ct, jnp.zeros((1, ct.shape[1]), ct.dtype)])
    pad = jnp.full((nrow - inv.shape[0],), ct.shape[0], inv.dtype)
    back = ctp[jnp.minimum(jnp.concatenate([inv, pad]), ct.shape[0])]
    z = np.zeros(inv.shape, dtype=jax.dtypes.float0)
    return back, z, z


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)

def blockify(positions: jax.Array, q: jax.Array, system, slots: jax.Array,
             inv_slot: jax.Array, wrap: jax.Array = None):
    """Gather atom data into cell-major blocks with a hand-written VJP.

    Both directions move ONE [*, 8] row table (one row gather instead of
    a gather per scalar column):

    * forward — gather the padded [N+1, 8] atom table (x y z q hs se 0 0)
      by slot -> atom;
    * backward — because ``slots`` is a permutation, the transpose is not a
      scatter: gather the [S+1, 8] cotangent table by the *inverse*
      permutation (atom -> slot).  7x faster than the row scatter-add, 17x
      faster than per-field scatters.

    The constant LJ prefactors get no cotangent (engine contract: no
    parameter gradients through the direct space).  Centralizing the layout
    change here means more block consumers (PME, future kernels) cost no
    extra gathers.
    """
    spec = system.spec
    gx, gy, gz = spec.cell_grid
    cap = spec.cell_capacity
    grid4 = (gx, gy, gz, cap)
    n = positions.shape[0]
    dtype = positions.dtype
    box = system.box
    flat = slots.reshape(-1)

    # With neighbor-state reuse, wrap offsets are frozen at rebuild time
    # so coordinates stay continuous across the periodic boundary.
    if wrap is None:
        pos_w = positions - wrap_offsets(positions, box)
    else:
        pos_w = positions - wrap
    table = jnp.concatenate(
        [pos_w, q[:, None], 0.5 * system.sigma.astype(dtype)[:, None],
         2.0 * jnp.sqrt(system.epsilon.astype(dtype))[:, None],
         jnp.zeros((n, 2), dtype)], axis=1)
    table = jnp.concatenate([table, jnp.zeros((1, 8), dtype)], axis=0)
    g4 = gather_rows(table, flat, inv_slot).reshape(grid4 + (8,))
    return CellBlocks(x=g4[..., 0], y=g4[..., 1], z=g4[..., 2],
                      q=g4[..., 3], hs=g4[..., 4], se=g4[..., 5])


def _roll_block_energy(blocks: CellBlocks, ids: jax.Array, system) -> jax.Array:
    """Roll-based direct-space sum over cell blocks — the plain-autodiff XLA
    path (used for energy-only queries and as the custom_vjp primal).

    The j-side slab for a neighbor shift (dx, dy, dz) is ``jnp.roll`` of the
    i-side arrays plus a *static* boundary image offset per axis.  No gathers
    inside the shift loop — and since the transpose of roll is roll, the
    backward pass has no scatters either (the autodiff-of-gather scatter-adds
    are what made the row-gather variant slow).  Half-shell: 13 rolled shifts
    plus the self cell with id_i < id_j.
    """
    spec = system.spec
    gx, gy, gz = spec.cell_grid
    n = system.n_atoms
    dtype = blocks.x.dtype
    box = system.box

    comp = [blocks.x, blocks.y, blocks.z]
    qc, hc, sc = blocks.q, blocks.hs, blocks.se
    valid = ids < n

    alpha = spec.alpha
    cutoff2 = spec.cutoff * spec.cutoff

    def block_energy(xi, xj, qj, hj, sj, mj, extra=None):
        """Pair energies between the i-grid and a j-slab; both
        [gx,gy,gz,cap]; returns masked scalar sum."""
        r2 = 0.0
        for k in range(3):
            dk = xi[k][..., :, None] - xj[k][..., None, :]
            r2 = r2 + dk * dk
        mask = valid[..., :, None] & mj[..., None, :] & (r2 < cutoff2)
        if extra is not None:
            mask = mask & extra
        r2s = jnp.where(mask, r2, 1.0)
        inv_r = jax.lax.rsqrt(r2s)
        if dtype == jnp.float64:
            kern = inv_r * erfc_fast(alpha * (r2s * inv_r))
        else:
            kern = inv_r - erf_over_r_eval(r2s, alpha, spec.cutoff)
        coul = ONE_4PI_EPS0 * (qc[..., :, None] * qj[..., None, :]) * kern
        sig2 = ((hc[..., :, None] + hj[..., None, :]) * inv_r) ** 2
        sig6 = sig2 * sig2 * sig2
        lj = (sc[..., :, None] * sj[..., None, :]) * sig6 * (sig6 - 1.0)
        return jnp.sum(jnp.where(mask, coul + lj, 0.0))

    def shifted(dx, dy, dz):
        # dx/dy/dz are trace-time constants; close over them so roll shifts
        # stay static, and checkpoint only the array-level computation.
        def f(cx, cy, cz):
            sh = (-dx, -dy, -dz)
            ax = (0, 1, 2)
            # static boundary image offsets (lattice rows when triclinic)
            ox, oy, oz = shift_image_offsets((gx, gy, gz), (dx, dy, dz),
                                             box, dtype)
            xj = [jnp.roll(cx, sh, ax) + ox,
                  jnp.roll(cy, sh, ax) + oy,
                  jnp.roll(cz, sh, ax) + oz]
            qj = jnp.roll(qc, sh, ax)
            hj = jnp.roll(hc, sh, ax)
            sj = jnp.roll(sc, sh, ax)
            mj = jnp.roll(valid, sh, ax)
            return block_energy([cx, cy, cz], xj, qj, hj, sj, mj)

        return jax.checkpoint(f)(comp[0], comp[1], comp[2])

    # self cell: ordered pairs i<j by global atom id
    same = ids[..., :, None] < ids[..., None, :]
    total = jax.checkpoint(block_energy)(comp, comp, qc, hc, sc, valid,
                                         extra=same)
    for (dx, dy, dz) in HALF_SHELL[1:]:
        total = total + shifted(dx, dy, dz)
    return total


def _roll_fused_walk(blocks: CellBlocks, ids: jax.Array, system):
    """One walk over the half-shell slabs computing energy, dE/dx and dE/dq
    together (explicit derivatives — no second/third autodiff walk).

    Returns (energy, dEdx-per-block [3 x grid4], dEdq-per-block [grid4]).
    Used as the forward pass of :func:`direct_energy_on_blocks`; the same
    fusion the CUDA computeNonbonded kernel does (PBCForce.cu:86-751).
    """
    spec = system.spec
    gx_, gy_, gz_ = spec.cell_grid
    cap = spec.cell_capacity
    n = system.n_atoms
    dtype = blocks.x.dtype
    box = system.box
    grid4 = (gx_, gy_, gz_, cap)

    comp = [blocks.x, blocks.y, blocks.z]
    qc, hc, sc = blocks.q, blocks.hs, blocks.se
    valid = ids < n

    alpha = spec.alpha
    cutoff2 = spec.cutoff * spec.cutoff

    def pair_walk(xj, qj, hj, sj, mj, extra=None):
        """Returns (e_sum, gi [3 x grid4+cap? -> per-i sums], gj, dqi, dqj)
        where gi/gj are lists of 3 arrays [*grid4] summed over the opposite
        pair axis."""
        dx = comp[0][..., :, None] - xj[0][..., None, :]
        dy = comp[1][..., :, None] - xj[1][..., None, :]
        dz = comp[2][..., :, None] - xj[2][..., None, :]
        r2 = dx * dx + dy * dy + dz * dz
        mask = valid[..., :, None] & mj[..., None, :] & (r2 < cutoff2)
        if extra is not None:
            mask = mask & extra
        r2s = jnp.where(mask, r2, 1.0)
        inv_r = jax.lax.rsqrt(r2s)
        u = inv_r * inv_r
        if dtype == jnp.float64:
            # exact erfc for the f64 parity path; d/dx erfc = -2/sqrt(pi) e^{-x^2}
            from jax.scipy.special import erfc as _erfc_exact
            r = r2s * inv_r
            x = alpha * r
            erfc_ar = _erfc_exact(x)
            derfc = (-2.0 / math.sqrt(math.pi)) * jnp.exp(-x * x)
            kern = inv_r * erfc_ar                    # erfc(ar)/r
            qq = (ONE_4PI_EPS0 * qc[..., :, None]) * qj[..., None, :]
            coul = qq * kern
            dcoul_over_r = (qq * derfc * alpha - coul) * u
        else:
            # erfc(ar)/r = 1/r - P(r^2) with dP/d(r^2) from the same
            # coefficients (dual Horner) — no exp/divide on the VPU path;
            # forces stay the exact gradient of the computed energy.
            p, dpds = erf_over_r_eval(r2s, alpha, spec.cutoff,
                                      with_derivative=True)
            kern = inv_r - p
            qq = (ONE_4PI_EPS0 * qc[..., :, None]) * qj[..., None, :]
            coul = qq * kern
            dcoul_over_r = -qq * (u * inv_r + 2.0 * dpds)
        sig2 = ((hc[..., :, None] + hj[..., None, :]) * inv_r) ** 2
        sig6 = sig2 * sig2 * sig2
        epr = sc[..., :, None] * sj[..., None, :]
        lj = epr * sig6 * (sig6 - 1.0)
        e = jnp.sum(jnp.where(mask, coul + lj, 0.0))
        dlj_over_r = -epr * sig6 * (12.0 * sig6 - 6.0) * u
        dEdr_over_r = jnp.where(mask, dcoul_over_r + dlj_over_r, 0.0)
        gi = [jnp.sum(dEdr_over_r * d, axis=-1) for d in (dx, dy, dz)]
        gj = [-jnp.sum(dEdr_over_r * d, axis=-2) for d in (dx, dy, dz)]
        ec = jnp.where(mask, kern, 0.0) * ONE_4PI_EPS0
        dqi = jnp.sum(ec * qj[..., None, :], axis=-1)
        dqj = jnp.sum(ec * qc[..., :, None], axis=-2)
        return e, gi, gj, dqi, dqj

    zero = jnp.zeros(grid4, dtype)
    g_acc = [zero, zero, zero]
    dq_acc = zero

    # self cell: i < j by global atom id
    same = ids[..., :, None] < ids[..., None, :]
    e_total, gi, gj, dqi, dqj = jax.checkpoint(pair_walk)(
        comp, qc, hc, sc, valid, extra=same)
    g_acc = [g + a + b for g, a, b in zip(g_acc, gi, gj)]
    dq_acc = dq_acc + dqi + dqj

    ax = (0, 1, 2)
    for (dx_, dy_, dz_) in HALF_SHELL[1:]:
        def f(cx, cy, cz, dxs=dx_, dys=dy_, dzs=dz_):
            sh = (-dxs, -dys, -dzs)
            ox, oy, oz = shift_image_offsets((gx_, gy_, gz_),
                                             (dxs, dys, dzs), box, dtype)
            xj = [jnp.roll(cx, sh, ax) + ox,
                  jnp.roll(cy, sh, ax) + oy,
                  jnp.roll(cz, sh, ax) + oz]
            qj = jnp.roll(qc, sh, ax)
            hj = jnp.roll(hc, sh, ax)
            sj = jnp.roll(sc, sh, ax)
            mj = jnp.roll(valid, sh, ax)
            e, gi, gj, dqi, dqj = pair_walk(xj, qj, hj, sj, mj)
            # j-side accumulations live in rolled coordinates; roll back.
            back = (dxs, dys, dzs)
            gj = [jnp.roll(g, back, ax) for g in gj]
            dqj = jnp.roll(dqj, back, ax)
            return e, gi, gj, dqi + dqj

        e, gi, gj, dq_both = jax.checkpoint(f)(comp[0], comp[1], comp[2])
        e_total = e_total + e
        g_acc = [g + a + b for g, a, b in zip(g_acc, gi, gj)]
        dq_acc = dq_acc + dq_both

    return e_total, g_acc, dq_acc


def _concat_slabs(blocks: CellBlocks, ids: jax.Array, system,
                  shifts=None):
    """Concatenate the 14 half-shell j-side slabs along the slot axis.

    Returns (xj [3 arrays of [gx,gy,gz,14*cap]], qj, hj, sj, idsj).  Slab 0
    is the (unrolled) self cell; slabs 1..13 are ``jnp.roll`` of the block
    arrays by the half-shell shifts, with the static boundary image offsets
    added to the coordinates.  The point of ``walk_layout="concat"``: when
    the pair tile's j axis pads to a hardware tile width, 14 separate
    [cap, cap] tiles pay that padding 14 times, while one [cap, 14*cap]
    tile pays it once.  Which layout the card prefers awaits an A/B."""
    spec = system.spec
    gx, gy, gz = spec.cell_grid
    dtype = blocks.x.dtype
    box = system.box
    ax = (0, 1, 2)

    xs, ys, zs, qs, hs_, ss, idss = [], [], [], [], [], [], []
    for (dx, dy, dz) in (HALF_SHELL if shifts is None else shifts):
        sh = (-dx, -dy, -dz)
        roll = lambda a: jnp.roll(a, sh, ax)
        ox, oy, oz = shift_image_offsets((gx, gy, gz), (dx, dy, dz), box,
                                         dtype)
        xs.append(roll(blocks.x) + ox)
        ys.append(roll(blocks.y) + oy)
        zs.append(roll(blocks.z) + oz)
        qs.append(roll(blocks.q))
        hs_.append(roll(blocks.hs))
        ss.append(roll(blocks.se))
        idss.append(roll(ids))
    cat = lambda lst: jnp.concatenate(lst, axis=-1)
    return ([cat(xs), cat(ys), cat(zs)], cat(qs), cat(hs_), cat(ss),
            cat(idss))


def _concat_tile(comp, qc, hc, sc, ids, xj, qj, hj, sj, idsj, system,
                 with_grads):
    """Pair-tile math of the concat-layout walk on prebuilt slab arrays.

    i-side arrays are [..., cap], j-side [..., 14*cap]; any leading shape.
    ``with_grads=False`` returns the scalar energy (plain-autodiff primal);
    ``with_grads=True`` returns (e, gi [3 x [..., cap]], gj
    [3 x [..., 14cap]], dqi, dqj) with the j-side sums still in slab-rolled
    coordinates (caller rolls them back per slab)."""
    spec = system.spec
    cap = spec.cell_capacity
    n = system.n_atoms
    dtype = comp[0].dtype
    valid = ids < n
    mj = idsj < n

    alpha = spec.alpha
    cutoff2 = spec.cutoff * spec.cutoff

    # The walk is pure elementwise math (variants that moved the gradient
    # contractions or the r^2 cross term into matmuls were deleted; git
    # history holds them).
    dx = comp[0][..., :, None] - xj[0][..., None, :]
    dy = comp[1][..., :, None] - xj[1][..., None, :]
    dz = comp[2][..., :, None] - xj[2][..., None, :]
    r2 = dx * dx + dy * dy + dz * dz
    # Self slab (first cap columns): ordered pairs i<j by global atom id;
    # the 13 rolled slabs take every in-range pair.  Computed inline so the
    # bool tensor stays inside the fused elementwise chain.
    ordered = ((jnp.arange(14 * cap, dtype=jnp.int32) >= cap)
               | (ids[..., :, None] < idsj[..., None, :]))
    mask = valid[..., :, None] & mj[..., None, :] & (r2 < cutoff2) & ordered
    r2s = jnp.where(mask, r2, 1.0)
    inv_r = jax.lax.rsqrt(r2s)
    qq = (ONE_4PI_EPS0 * qc[..., :, None]) * qj[..., None, :]
    if dtype == jnp.float64:
        from jax.scipy.special import erfc as _erfc_exact
        r = r2s * inv_r
        x = alpha * r
        kern = inv_r * _erfc_exact(x)
        coul = qq * kern
        if with_grads:
            derfc = (-2.0 / math.sqrt(math.pi)) * jnp.exp(-x * x)
            dcoul_over_r = (qq * derfc * alpha - coul) * (inv_r * inv_r)
    else:
        if with_grads:
            p, dpds = erf_over_r_eval(r2s, alpha, spec.cutoff,
                                      with_derivative=True)
        else:
            p = erf_over_r_eval(r2s, alpha, spec.cutoff)
        kern = inv_r - p
        coul = qq * kern
        if with_grads:
            u = inv_r * inv_r
            dcoul_over_r = -qq * (u * inv_r + 2.0 * dpds)
    sig2 = ((hc[..., :, None] + hj[..., None, :]) * inv_r) ** 2
    sig6 = sig2 * sig2 * sig2
    epr = sc[..., :, None] * sj[..., None, :]
    lj = epr * sig6 * (sig6 - 1.0)
    e = jnp.sum(jnp.where(mask, coul + lj, 0.0))
    if not with_grads:
        return e
    dlj_over_r = -epr * sig6 * (12.0 * sig6 - 6.0) * (inv_r * inv_r)
    dEdr_over_r = jnp.where(mask, dcoul_over_r + dlj_over_r, 0.0)
    gi = [jnp.sum(dEdr_over_r * d, axis=-1) for d in (dx, dy, dz)]
    gj = [-jnp.sum(dEdr_over_r * d, axis=-2) for d in (dx, dy, dz)]
    ec = jnp.where(mask, kern, 0.0) * ONE_4PI_EPS0
    dqi = jnp.sum(ec * qj[..., None, :], axis=-1)
    dqj = jnp.sum(ec * qc[..., :, None], axis=-2)
    return e, gi, gj, dqi, dqj


def _concat_pair_core(blocks, ids, system, with_grads):
    """Concat-layout walk: build slabs once, then one pair tile — chunked
    over the leading (x) cell axis when ``spec.walk_chunks > 1``.

    The per-chunk gj/dqj slabs are indexed by i-cell rows, so chunks stack
    straight back to the full grid and the per-slab roll-backs happen once
    after the scan (in :func:`_concat_fused_walk`).  Chunking bounds the
    live pair-tile memory to tile_bytes / walk_chunks — the unchunked tile
    OOMed the 100k config on a 16 GB chip."""
    spec = system.spec
    gx = spec.cell_grid[0]
    xj, qj, hj, sj, idsj = _concat_slabs(blocks, ids, system)
    comp = [blocks.x, blocks.y, blocks.z]
    qc, hc, sc = blocks.q, blocks.hs, blocks.se
    chunks = getattr(spec, "walk_chunks", 1)
    if chunks <= 1 or gx % chunks != 0:
        return _concat_tile(comp, qc, hc, sc, ids, xj, qj, hj, sj, idsj,
                            system, with_grads)
    bx = gx // chunks

    def body(carry, c):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * bx, bx, axis=0)
        res = _concat_tile([sl(a) for a in comp], sl(qc), sl(hc), sl(sc),
                           sl(ids), [sl(a) for a in xj], sl(qj), sl(hj),
                           sl(sj), sl(idsj), system, with_grads)
        if not with_grads:
            return carry, res
        e, gi, gj, dqi, dqj = res
        return carry, (e, gi[0], gi[1], gi[2], gj[0], gj[1], gj[2],
                       dqi, dqj)

    _, out = jax.lax.scan(body, None, jnp.arange(chunks, dtype=jnp.int32))
    unstack = lambda a: a.reshape((gx,) + a.shape[2:])
    if not with_grads:
        return jnp.sum(out)
    es, g0, g1, g2, j0, j1, j2, dqi, dqj = out
    return (jnp.sum(es), [unstack(g0), unstack(g1), unstack(g2)],
            [unstack(j0), unstack(j1), unstack(j2)],
            unstack(dqi), unstack(dqj))


def _concat_block_energy(blocks: CellBlocks, ids: jax.Array,
                         system) -> jax.Array:
    """Concat-layout direct-space energy (plain-autodiff / primal path)."""
    return jax.checkpoint(
        lambda b: _concat_pair_core(b, ids, system, with_grads=False))(blocks)


def _concat_fused_walk(blocks: CellBlocks, ids: jax.Array, system):
    """Concat-layout fused walk: energy, dE/dx and dE/dq in one pair tile.

    Same contract as :func:`_roll_fused_walk`; the j-side accumulations come
    back as [.., 14*cap] slabs in rolled coordinates and are rolled back and
    summed per half-shell shift here."""
    spec = system.spec
    cap = spec.cell_capacity
    ax = (0, 1, 2)
    e, gi, gj, dqi, dqj = _concat_pair_core(blocks, ids, system,
                                            with_grads=True)
    g_acc = list(gi)
    dq_acc = dqi
    for s, (dx_, dy_, dz_) in enumerate(HALF_SHELL):
        back = (dx_, dy_, dz_)
        sl = slice(s * cap, (s + 1) * cap)
        for k in range(3):
            g_acc[k] = g_acc[k] + jnp.roll(gj[k][..., sl], back, ax)
        dq_acc = dq_acc + jnp.roll(dqj[..., sl], back, ax)
    return e, g_acc, dq_acc


def direct_energy_on_blocks(blocks: CellBlocks, ids: jax.Array,
                            system) -> jax.Array:
    """Direct-space energy over cell blocks with a hand-written VJP: the
    forward pass computes energy + dE/dx + dE/dq in ONE slab walk
    (:func:`_roll_fused_walk`); backward is a scale.  Cotangents flow into
    the block arrays — :func:`blockify`'s VJP performs the single scatter
    back to atom order, shared with every other block consumer.

    ``ids`` is an explicit custom_vjp argument with a float0 cotangent
    (NOT a closure): fwd/bwd closing over forward-trace *index* tracers
    breaks under the shard_map transpose (repo rule; see gather_rows)."""

    layout = system.spec.walk_layout
    concat = layout.startswith("concat")
    primal = _concat_block_energy if concat else _roll_block_energy
    fused = _concat_fused_walk if concat else _roll_fused_walk

    @jax.custom_vjp
    def direct_energy(blocks, ids):
        return primal(blocks, ids, system)

    def _fwd(blocks, ids):
        e, g_acc, dq_acc = fused(blocks, ids, system)
        return e, (g_acc, dq_acc, ids.shape)

    def _bwd(res, g_out):
        g_acc, dq_acc, ids_shape = res
        zero = jnp.zeros_like(dq_acc)
        blocks_ct = CellBlocks(x=g_out * g_acc[0], y=g_out * g_acc[1],
                               z=g_out * g_acc[2], q=g_out * dq_acc,
                               hs=zero, se=zero)
        return blocks_ct, np.zeros(ids_shape, dtype=jax.dtypes.float0)

    direct_energy.defvjp(_fwd, _bwd)
    return direct_energy(blocks, ids)


def cell_roll_direct_energy(positions: jax.Array, q: jax.Array,
                            system) -> jax.Array:
    """Roll-based direct-space sum via plain autodiff (no fused walk);
    the reference XLA path for equality tests."""
    spec = system.spec
    slots, inv_slot, _ = build_cell_list_full(positions, system.box,
                                              spec.cell_grid,
                                              spec.cell_capacity)
    blocks = blockify(positions, q, system, slots, inv_slot)
    ids = slots.reshape(blocks.x.shape)
    return _roll_block_energy(blocks, ids, system)


def cell_roll_fused_energy(positions, q, system):
    """Direct-space energy with the fused-walk VJP (standalone wrapper;
    energy.py builds the blocks once and shares them with PME)."""
    spec = system.spec
    slots, inv_slot, _ = build_cell_list_full(positions, system.box,
                                              spec.cell_grid,
                                              spec.cell_capacity)
    blocks = blockify(positions, q, system, slots, inv_slot)
    ids = slots.reshape(blocks.x.shape)
    return direct_energy_on_blocks(blocks, ids, system)


def cell_list_direct_energy(positions: jax.Array, q: jax.Array, system) -> jax.Array:
    """Direct-space erfc Coulomb + LJ over all in-cutoff pairs (excluded
    pairs included; corrected by energy.py)."""
    return cell_roll_fused_energy(positions, q, system)
