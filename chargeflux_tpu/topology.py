"""Molecule-template detection — static slices in place of per-term scatters.

The reference processes flux terms one CUDA thread per term with atomic
scatters (calcChargeFlux.cu:29-289).  Gathers and scatters break XLA's
fusion and move data by index, while the arithmetic per term is tiny.

The observation: flux/exclusion *indices* are static, and in real MD systems
they almost always form a repeating per-molecule pattern — C copies of an
s-atom molecule occupying the contiguous atom range [offset, offset + C*s),
each copy carrying the same local term structure.  When that holds, every
term evaluation reshapes to [C, s, 3] with *static* per-slot slices: no
gathers, no scatters, and the autodiff backward is pad/slice.  Parameters (k, b, theta0, ...) may differ per copy; only the index
structure must repeat.

Detection runs once at system build time in NumPy (the analog of the
reference baking NUM_FLUX_* into NVRTC macros, CudaCoulKernels.cpp:377-389);
systems that don't match simply fall back to the general scatter path.

Heterogeneous topologies: real solvated systems are a LIST of
repeated blocks — a solute, thousands of waters, some ions — not one.
:func:`detect_templates` partitions the term graph's connected components
into maximal evenly-spaced runs of identical structure; each run becomes a
:class:`MoleculeTemplate`, and everything that doesn't repeat (the solute)
stays on the general gather/scatter path as a *remainder*.  The reference
is topology-agnostic by construction (CoulForce.h:137-149); this recovers
that generality while keeping the solvent majority gather-free.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Bounds on what we unroll into the trace.  Each template row costs a
# handful of XLA ops and each molecule slot a static slice; these keep the
# jaxpr small while covering water models, small solutes and typical repeat
# units.  Larger molecules fall back to the general scatter path.
TEMPLATE_UNROLL_LIMIT = 128   # term rows per molecule
TEMPLATE_STRIDE_LIMIT = 64    # atoms per molecule
# Multi-template bounds: a run shorter than MIN_TEMPLATE_COUNT isn't worth
# a reshape path (the scatter remainder handles it); more than
# MAX_TEMPLATES distinct blocks would bloat the jaxpr (keep the largest).
MIN_TEMPLATE_COUNT = 4
MAX_TEMPLATES = 8


@dataclasses.dataclass(frozen=True)
class MoleculeTemplate:
    """Hashable description of a repeating molecular block.

    ``count`` copies of an ``stride``-atom molecule occupy atoms
    [offset, offset + count*stride).  Each ``rows[kind]`` entry is the local
    (0-based, < stride) index tuple of one term of that kind, in the order
    the corresponding system arrays are stored (molecule-major).
    """

    offset: int
    stride: int
    count: int
    # kind name -> tuple of local index tuples (one per term in molecule 0)
    rows: Tuple[Tuple[str, Tuple[Tuple[int, ...], ...]], ...]

    def local_rows(self, kind: str) -> Tuple[Tuple[int, ...], ...]:
        for k, v in self.rows:
            if k == kind:
                return v
        return ()

    @property
    def n_rows(self) -> int:
        return sum(len(v) for _, v in self.rows)


@dataclasses.dataclass(frozen=True)
class TemplateSet:
    """Hashable set of non-overlapping molecule templates plus a remainder.

    Per kind, the system's term arrays are reordered
    ``[templates[0] rows (molecule-major) | templates[1] ... | remainder]``;
    :meth:`covered` gives the number of template rows so consumers slice the
    remainder as ``rows[covered:]`` and run the general gather/scatter path
    on just that tail (the solute), keeping the solvent majority on the
    static-slice path.  ``templates`` are sorted by ``offset`` and their
    atom blocks ``[offset, offset + count*stride)`` never overlap — charge
    assembly concatenates the block segments in order.
    """

    templates: Tuple[MoleculeTemplate, ...]
    # kind name -> number of rows NOT covered by any template (the tail)
    remainder: Tuple[Tuple[str, int], ...]

    def covered(self, kind: str, total: int) -> int:
        """Rows of ``kind`` covered by templates, given the array total."""
        for k, v in self.remainder:
            if k == kind:
                return total - v
        return total

    @property
    def n_rows(self) -> int:
        return sum(t.n_rows for t in self.templates)


def _component_labels(nonempty):
    """Connected components of the term graph over referenced atoms.

    Atoms referenced by the same row are one component ("molecule").
    Label propagation with pointer jumping on the compressed
    referenced-atom set — pure NumPy, runs once at build time.  Returns
    (ref, root_inv, comp_min, comp_max): the sorted unique referenced
    atoms, each atom's component id (0..n_comp), and per-component
    min/max atom ids; or None if propagation fails to converge.
    """
    ref = np.unique(np.concatenate([v.reshape(-1) for v in nonempty.values()]))
    labels = np.arange(len(ref), dtype=np.int64)
    # hub edges: (row_min, member) for every row member
    hubs = []
    members = []
    for v in nonempty.values():
        c = np.searchsorted(ref, v)       # [T, w] compressed
        hub = c.min(axis=1)
        hubs.append(np.repeat(hub, v.shape[1]))
        members.append(c.reshape(-1))
    hub = np.concatenate(hubs)
    mem = np.concatenate(members)
    for _ in range(64):
        pair_min = np.minimum(labels[hub], labels[mem])
        new = labels.copy()
        np.minimum.at(new, hub, pair_min)
        np.minimum.at(new, mem, pair_min)
        new = new[new]                    # pointer jumping
        if np.array_equal(new, labels):
            break
        labels = new
    else:
        return None
    roots, root_inv = np.unique(labels, return_inverse=True)
    n_comp = len(roots)
    comp_min = np.full(n_comp, np.iinfo(np.int64).max)
    np.minimum.at(comp_min, root_inv, ref)
    comp_max = np.full(n_comp, -1, dtype=np.int64)
    np.maximum.at(comp_max, root_inv, ref)
    return ref, root_inv, comp_min, comp_max


def detect_templates(kinds: Dict[str, np.ndarray],
                     n_atoms: int,
                     min_count: int = MIN_TEMPLATE_COUNT,
                     max_templates: int = MAX_TEMPLATES):
    """Detect a LIST of repeating molecule blocks plus a scatter remainder.

    Args:
      kinds: kind name -> int index array [T_kind, width]; empty arrays are
        allowed (and recorded with zero template rows).
      n_atoms: total atom count (template blocks must fit inside it).
      min_count: runs shorter than this stay on the scatter path (an
        unrolled reshape over 2 molecules buys nothing).
      max_templates: keep only the largest blocks (by covered rows) when
        the topology fragments further; the rest join the remainder.

    Returns:
      (TemplateSet, perms) where ``perms[kind]`` reorders that kind's rows
      as [template 0 molecule-major | template 1 ... | remainder rows], or
      None when nothing repeats enough to template (every row is then
      remainder — callers keep the plain scatter path).
    """
    nonempty = {k: np.asarray(v, dtype=np.int64)
                for k, v in kinds.items() if np.size(v)}
    if not nonempty:
        return None
    lab = _component_labels(nonempty)
    if lab is None:
        return None
    ref, root_inv, comp_min, comp_max = lab
    n_comp = len(comp_min)

    # Per-component rows: kind -> [(local index tuple, original row)] —
    # locals are relative to the component's min atom.
    comp_rows = [dict() for _ in range(n_comp)]
    for kind, v in nonempty.items():
        c = np.searchsorted(ref, v)
        rc = root_inv[c[:, 0]]
        # every atom of a row must sit in the row's own component
        if not np.all(root_inv[c] == rc[:, None]):
            return None        # cannot happen (rows define components)
        local = v - comp_min[rc][:, None]
        for t in range(v.shape[0]):
            comp_rows[rc[t]].setdefault(kind, []).append(
                (tuple(int(x) for x in local[t]), t))

    # Structure signature: per kind, the multiset of local rows (sorted —
    # also the canonical within-molecule row order used by the perms).
    sigs = []
    for cr in comp_rows:
        sigs.append(tuple(sorted(
            (kind, tuple(sorted(loc for loc, _ in rows)))
            for kind, rows in cr.items())))

    order = np.argsort(comp_min, kind="stable")
    mins = comp_min[order]

    # Greedy maximal runs: same signature, constant spacing >= span.
    runs = []                  # (start position in `order`, count, stride)
    i = 0
    n_o = len(order)
    while i < n_o:
        c0 = int(order[i])
        span0 = int(comp_max[c0] - comp_min[c0] + 1)
        j = i + 1
        stride = None
        while j < n_o:
            cj = int(order[j])
            if sigs[cj] != sigs[c0]:
                break
            sp = int(mins[j] - mins[j - 1])
            if stride is None:
                if sp < span0:
                    break
                stride = sp
            elif sp != stride:
                break
            j += 1
        count = j - i
        stride_eff = span0 if count == 1 else stride
        # trailing molecules whose stride tail would swallow the next
        # component's atoms (or run past the atom array) drop back out
        while count >= 1:
            end = int(mins[i]) + count * stride_eff
            nxt = int(mins[i + count]) if i + count < n_o else n_atoms
            if end <= min(nxt, n_atoms):
                break
            count -= 1
            if count == 1:
                stride_eff = span0
        n_mol_rows = sum(len(r) for _, r in sigs[c0])
        if (count >= min_count and 0 < stride_eff <= TEMPLATE_STRIDE_LIMIT
                and n_mol_rows <= TEMPLATE_UNROLL_LIMIT):
            runs.append((i, count, stride_eff))
            i += count
        else:
            i += 1

    if not runs:
        return None
    # keep the largest runs by covered row count
    if len(runs) > max_templates:
        keep = sorted(sorted(runs, key=lambda r: -(
            r[1] * sum(len(v) for _, v in sigs[int(order[r[0]])])
        ))[:max_templates])
        runs = keep

    templates = []
    # perms assembled per kind: template rows first (run order =
    # offset order), remainder rows (original order) appended after
    tpl_rows: Dict[str, list] = {k: [] for k in kinds}
    for (pos, count, stride_eff) in runs:
        c0 = int(order[pos])
        rows = []
        for kind in kinds:
            rows.append((kind, tuple(
                loc for loc, _ in sorted(comp_rows[c0].get(kind, ())))))
        templates.append(MoleculeTemplate(
            offset=int(mins[pos]), stride=int(stride_eff), count=int(count),
            rows=tuple(rows)))
        for p in range(pos, pos + count):
            cp = int(order[p])
            for kind in kinds:
                tpl_rows[kind].extend(
                    t for _, t in sorted(comp_rows[cp].get(kind, ())))

    perms: Dict[str, np.ndarray] = {}
    remainder = []
    for kind in kinds:
        total = int(np.asarray(kinds[kind]).shape[0]) if np.size(
            kinds[kind]) else 0
        covered = set(tpl_rows[kind])
        rem = [t for t in range(total) if t not in covered]
        perms[kind] = np.asarray(tpl_rows[kind] + rem, dtype=np.int64)
        remainder.append((kind, len(rem)))

    ts = TemplateSet(templates=tuple(templates), remainder=tuple(remainder))
    return ts, perms


def detect_template(kinds: Dict[str, np.ndarray],
                    n_atoms: Optional[int] = None):
    """Single-template detection: succeeds only when
    ONE block covers every row.  Kept for callers/tests that reason about
    the homogeneous case; new code uses :func:`detect_templates`.

    Contract note: when ``n_atoms`` is omitted it is inferred as
    ``max_index + 1``, so a homogeneous system whose molecule stride
    exceeds its indexed atom span (trailing gap atoms after the last
    indexed one) has its final molecule classified as remainder and this
    shim returns None.  Results stay correct via the scatter path — pass
    the true ``n_atoms`` to recover the template in that case."""
    if n_atoms is None:
        vals = [np.asarray(v, dtype=np.int64)
                for v in kinds.values() if np.size(v)]
        if not vals:
            return None
        n_atoms = int(max(int(v.max()) for v in vals)) + 1
    det = detect_templates(kinds, n_atoms, min_count=1)
    if det is None:
        return None
    ts, perms = det
    if len(ts.templates) != 1 or any(c for _, c in ts.remainder):
        return None
    return ts.templates[0], perms
