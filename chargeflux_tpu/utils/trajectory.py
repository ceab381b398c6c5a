"""Trajectory IO: XYZ frames (human-readable), PDB, and binary DCD.

The reference plugin inherits reporting from OpenMM (SURVEY §1 L0 — DCD /
state-data reporters live in the host framework); a standalone engine has
to ship both: XYZ as the zero-dependency human-readable format, and
CHARMM/NAMD DCD (:class:`DCDWriter`) so trajectories drop straight into
the VMD / MDAnalysis / mdtraj stacks reference users already run.  The
DCD path is backed by the native C++ runtime (csrc/chargeflux_host.cpp,
buffered fwrite — the same division of labor as the reference's C++ host
code) with a pure-Python fallback when no compiler is available.
Coordinates convert nm -> Angstrom on write (both formats' convention).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

# mass (amu) -> element, for the species this engine's models produce;
# nearest-match lookup so slightly customized masses still resolve
_MASS_TABLE = (
    (1.008, "H"), (12.011, "C"), (14.007, "N"), (15.999, "O"),
    (22.99, "Na"), (35.45, "Cl"),
)


def symbols_from_masses(masses: Sequence[float]) -> list:
    """Best-effort element symbols by nearest tabulated mass (> 20%
    mismatch falls back to 'X'); pass explicit symbols to write_xyz when
    the system has species outside the table."""
    out = []
    for m in np.asarray(masses, dtype=np.float64):
        best, sym = None, "X"
        for ref, s in _MASS_TABLE:
            d = abs(m - ref)
            if best is None or d < best:
                best, sym = d, s
        out.append(sym if best <= 0.2 * m else "X")
    return out


def write_xyz(path: str, frames, symbols: Optional[Sequence[str]] = None,
              masses: Optional[Sequence[float]] = None,
              comments: Optional[Iterable[str]] = None,
              append: bool = False) -> int:
    """Write one or many frames of [N, 3] nm coordinates as XYZ (Angstrom).

    ``frames``: a single [N, 3] array or an iterable / [F, N, 3] stack.
    Element symbols come from ``symbols``, else ``masses`` (nearest-match),
    else every atom is 'X'.  Returns the number of frames written.
    """
    frames = np.asarray(frames, dtype=np.float64)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.ndim != 3 or frames.shape[-1] != 3:
        raise ValueError(f"expected [N,3] or [F,N,3] frames, got "
                         f"{frames.shape}")
    n = frames.shape[1]
    if symbols is None:
        symbols = (symbols_from_masses(masses) if masses is not None
                   else ["X"] * n)
    if len(symbols) != n:
        raise ValueError(f"{len(symbols)} symbols for {n} atoms")
    if comments is None:
        comments = [f"frame {i}" for i in range(frames.shape[0])]
    else:
        comments = list(comments)
        if len(comments) != frames.shape[0]:
            raise ValueError(f"{len(comments)} comments for "
                             f"{frames.shape[0]} frames")
    with open(path, "a" if append else "w") as fh:
        for frame, comment in zip(frames, comments):
            fh.write(f"{n}\n{comment}\n")
            ang = frame * 10.0                       # nm -> Angstrom
            for s, (px, py, pz) in zip(symbols, ang):
                fh.write(f"{s} {px:.6f} {py:.6f} {pz:.6f}\n")
    return frames.shape[0]


def read_xyz(path: str):
    """Read an XYZ file back: (frames [F, N, 3] nm, symbols, comments).
    Round-trip counterpart of write_xyz (for tests and quick analysis)."""
    frames, comments, symbols = [], [], None
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i])
        comments.append(lines[i + 1])
        rows, syms = [], []
        for ln in lines[i + 2:i + 2 + n]:
            parts = ln.split()
            syms.append(parts[0])
            rows.append([float(v) for v in parts[1:4]])
        if symbols is None:
            symbols = syms
        frames.append(rows)
        i += 2 + n
    return np.asarray(frames, np.float64) / 10.0, symbols, comments


# ---------------------------------------------------------------------------
# PDB — the OpenMM ecosystem's interchange format
# ---------------------------------------------------------------------------
#
# The reference plugin's users hand OpenMM a PDB (simtk PDBFile) and build
# the CoulForce from its topology; a standalone engine needs the same
# on-ramp.  Reader/writer cover the subset MD tools produce: CRYST1
# (orthorhombic or triclinic), ATOM/HETATM, MODEL/ENDMDL multi-frame.
# Coordinates convert nm <-> Angstrom at the boundary.


class PDBFile:
    """Parsed PDB: ``frames`` [F, N, 3] nm, per-atom ``symbols`` /
    ``names`` / ``resnames`` / ``resseq``, and ``box`` (None, [3] nm
    edge vector when orthorhombic, or the reduced [3, 3] row-vector
    lattice when triclinic)."""

    def __init__(self, frames, symbols, names, resnames, resseq, box):
        self.frames = frames
        self.symbols = symbols
        self.names = names
        self.resnames = resnames
        self.resseq = resseq
        self.box = box

    @property
    def positions(self):
        """First frame, [N, 3] nm."""
        return self.frames[0]


# Two-letter elements a force field plausibly names in the atom-name
# field (ions, metals); used only by the element fallback when PDB
# columns 77-78 are empty.
_TWO_LETTER_ELEMENTS = frozenset((
    "Na", "Cl", "Mg", "Ca", "Zn", "Fe", "Br", "Mn", "Cu", "Se", "Li",
    "Al", "Si", "Ni", "Co", "Cd", "Hg", "Pb", "Ba", "Sr", "Cs", "Rb"))


def _element_from_name(name4: str) -> str:
    """Element from the 4-char PDB atom-name field when cols 77-78 are
    empty.  PDB right-justifies one-letter elements at column 14 (so
    ``name4[0]`` is blank or a digit); a name starting at column 13 is a
    two-letter element candidate — accepted only when the capitalized
    pair is a known element, so 'HW1'/'HB2' stay H, 'CL'/'NA' become
    Cl/Na (first-char-only would misread Cl/Na/Mg as C/N/M)."""
    stripped = name4.strip().lstrip("0123456789")
    if not stripped or not stripped[0].isalpha():
        return "X"
    if name4[0] not in " 0123456789" and len(stripped) >= 2 \
            and stripped[1].isalpha():
        two = stripped[0].upper() + stripped[1].lower()
        if two in _TWO_LETTER_ELEMENTS:
            return two
    return stripped[0]


def _lattice_from_cryst1(a, b, c, alpha, beta, gamma):
    """Reduced row-vector lattice (nm) from CRYST1 lengths (Angstrom) and
    angles (degrees) — the standard crystallographic frame: a along x,
    b in the xy plane."""
    a, b, c = a / 10.0, b / 10.0, c / 10.0
    al, be, ga = (np.radians(v) for v in (alpha, beta, gamma))
    if max(abs(alpha - 90), abs(beta - 90), abs(gamma - 90)) < 1e-6:
        return np.array([a, b, c])
    cx = c * np.cos(be)
    cy = c * (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return np.array([[a, 0.0, 0.0],
                     [b * np.cos(ga), b * np.sin(ga), 0.0],
                     [cx, cy, cz]])


def write_pdb(path: str, frames, box=None,
              symbols: Optional[Sequence[str]] = None,
              masses: Optional[Sequence[float]] = None,
              names: Optional[Sequence[str]] = None,
              resnames: Optional[Sequence[str]] = None,
              resseq: Optional[Sequence[int]] = None) -> int:
    """Write [N, 3] nm coordinates (or an [F, N, 3] stack as
    MODEL/ENDMDL frames) as PDB.  ``box`` ([3] or [3, 3] nm) emits a
    CRYST1 record.  Atom ``names``/``resnames``/``resseq`` default to the
    element symbol / 'MOL' / residue 1; serials past the fixed-width
    columns wrap (readers key on order, not serial).  Returns the number
    of frames written."""
    frames = np.asarray(frames, dtype=np.float64)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.ndim != 3 or frames.shape[-1] != 3:
        raise ValueError(f"expected [N,3] or [F,N,3] frames, got "
                         f"{frames.shape}")
    n = frames.shape[1]
    if symbols is None:
        symbols = (symbols_from_masses(masses) if masses is not None
                   else ["X"] * n)
    names = list(names) if names is not None else list(symbols)
    resnames = list(resnames) if resnames is not None else ["MOL"] * n
    resseq = list(resseq) if resseq is not None else [1] * n
    for label, seq in (("symbols", symbols), ("names", names),
                       ("resnames", resnames), ("resseq", resseq)):
        if len(seq) != n:
            raise ValueError(f"{len(seq)} {label} for {n} atoms")
    multi = frames.shape[0] > 1
    with open(path, "w") as fh:
        if box is not None:
            rec = _cell_record(box)      # [A, gamma, B, beta, alpha, C]
            fh.write(f"CRYST1{rec[0]:9.3f}{rec[2]:9.3f}{rec[5]:9.3f}"
                     f"{rec[4]:7.2f}{rec[3]:7.2f}{rec[1]:7.2f} P 1\n")
        for f, frame in enumerate(frames):
            if multi:
                fh.write(f"MODEL {f + 1:8d}\n")
            ang = frame * 10.0
            for i in range(n):
                nm = names[i][:4]
                nm = f" {nm:<3s}" if len(nm) < 4 else nm
                fh.write(
                    f"ATOM  {(i % 99999) + 1:5d} {nm} {resnames[i][:3]:<3s} "
                    f"A{(resseq[i] - 1) % 9999 + 1:4d}    "
                    f"{ang[i, 0]:8.3f}{ang[i, 1]:8.3f}{ang[i, 2]:8.3f}"
                    f"  1.00  0.00          {symbols[i][:2]:>2s}\n")
            fh.write("ENDMDL\n" if multi else "END\n")
    return frames.shape[0]


def read_pdb(path: str) -> PDBFile:
    """Parse a PDB file (ATOM/HETATM, CRYST1, MODEL/ENDMDL).  Atom
    metadata comes from the first frame; all frames must have the same
    atom count."""
    frames, cur = [], []
    names, resnames, resseq, symbols = [], [], [], []
    box = None
    first = True
    with open(path) as fh:
        for line in fh:
            tag = line[:6]
            if tag == "CRYST1":
                a, b, c = (float(line[6:15]), float(line[15:24]),
                           float(line[24:33]))
                al, be, ga = (float(line[33:40]), float(line[40:47]),
                              float(line[47:54]))
                box = _lattice_from_cryst1(a, b, c, al, be, ga)
            elif tag in ("ATOM  ", "HETATM"):
                cur.append([float(line[30:38]), float(line[38:46]),
                            float(line[46:54])])
                if first:
                    names.append(line[12:16].strip())
                    resnames.append(line[17:20].strip())
                    try:
                        resseq.append(int(line[22:26]))
                    except ValueError:
                        resseq.append(len(resseq) + 1)
                    el = line[76:78].strip() if len(line) >= 78 else ""
                    if not el:
                        el = _element_from_name(line[12:16])
                    symbols.append(el[:1].upper() + el[1:].lower())
            elif tag.startswith(("ENDMDL", "MODEL")) and cur:
                frames.append(cur)
                cur, first = [], False
    if cur:
        frames.append(cur)
    if not frames:
        raise ValueError(f"no ATOM records in {path}")
    if any(len(f) != len(frames[0]) for f in frames):
        raise ValueError("inconsistent atom counts across MODEL frames")
    return PDBFile(np.asarray(frames, np.float64) / 10.0, symbols, names,
                   resnames, resseq, box)


# ---------------------------------------------------------------------------
# DCD (CHARMM/NAMD binary) — native-backed writer with Python fallback
# ---------------------------------------------------------------------------


def _cell_record(box) -> np.ndarray:
    """[A, gamma, B, beta, alpha, C] in Angstrom/degrees from a [3] edge
    vector or [3, 3] row-lattice matrix (the NAMD/MDAnalysis unit-cell
    record convention)."""
    b = np.asarray(box, np.float64)
    if b.ndim == 2:
        a_v, b_v, c_v = b * 10.0
        la, lb, lc = (np.linalg.norm(v) for v in (a_v, b_v, c_v))

        def ang(u, v):
            return float(np.degrees(np.arccos(
                np.clip(np.dot(u, v) / (np.linalg.norm(u)
                                        * np.linalg.norm(v)), -1.0, 1.0))))

        return np.array([la, ang(a_v, b_v), lb, ang(a_v, c_v),
                         ang(b_v, c_v), lc])
    L = b * 10.0
    return np.array([L[0], 90.0, L[1], 90.0, 90.0, L[2]])


class DCDWriter:
    """Stream MD frames to a CHARMM/NAMD DCD file.

    ``box``-carrying frames write unit-cell records ([A, gamma, B, beta,
    alpha, C], degrees); pass ``with_cell=False`` for vacuum systems.
    Positions are [N, 3] in nm (converted to the format's Angstrom).
    Context-manager friendly; ``close()`` back-patches the frame/step
    counts in the header.

        with DCDWriter("run.dcd", n_atoms, dt_ps=dt, interval=100) as w:
            for chunk in ...:
                w.write(x, box=system.box)
    """

    def __init__(self, path, n_atoms: int, dt_ps: float = 0.001,
                 interval: int = 1, with_cell: bool = True):
        from ..runtime.native import dcd_native_handle

        self.path = str(path)
        self.n_atoms = int(n_atoms)
        self.with_cell = bool(with_cell)
        self.interval = int(interval)
        self.n_frames = 0
        self._native = dcd_native_handle(self.path, self.n_atoms, dt_ps,
                                         self.interval, self.with_cell)
        self._fh = None
        if self._native is None:
            self._fh = open(self.path, "wb")
            self._write_header_py(dt_ps)

    # -- pure-Python fallback (format mirror of csrc cf_dcd_*) -------------

    def _rec(self, payload: bytes):
        import struct
        self._fh.write(struct.pack("<i", len(payload)) + payload
                       + struct.pack("<i", len(payload)))

    def _write_header_py(self, dt_ps):
        import struct
        ic = [0] * 20
        ic[1] = ic[2] = self.interval
        ic[10] = 1 if self.with_cell else 0
        ic[19] = 24
        hdr = b"CORD" + struct.pack("<9i", *ic[:9]) \
            + struct.pack("<f", dt_ps / 0.04888821) \
            + struct.pack("<10i", *ic[10:])
        self._rec(hdr)
        title = b"Created by chargeflux_tpu".ljust(80)
        self._rec(struct.pack("<i", 1) + title)
        self._rec(struct.pack("<i", self.n_atoms))

    def write(self, positions, box=None) -> None:
        x = np.ascontiguousarray(np.asarray(positions, np.float64) * 10.0)
        if x.shape != (self.n_atoms, 3):
            raise ValueError(f"expected [{self.n_atoms}, 3], got {x.shape}")
        if self.with_cell:
            if box is None:
                raise ValueError("with_cell writer needs a box per frame")
            cell = np.ascontiguousarray(_cell_record(box))
        if self._native is not None:
            lib, h = self._native
            import ctypes
            cptr = cell.ctypes.data_as(ctypes.c_void_p) if self.with_cell \
                else None
            rc = lib.cf_dcd_write_frame(h, x.reshape(-1), cptr)
            if rc != 0:
                raise OSError(f"native DCD write failed (rc={rc})")
        else:
            if self.with_cell:
                self._rec(cell.astype("<f8").tobytes())
            xf = x.astype("<f4")
            for axis in range(3):
                self._rec(np.ascontiguousarray(xf[:, axis]).tobytes())
        self.n_frames += 1

    def close(self) -> None:
        import struct
        if self._native is not None:
            lib, h = self._native
            self._native = None
            lib.cf_dcd_close(h)
        elif self._fh is not None:
            self._fh.seek(8)
            self._fh.write(struct.pack("<i", self.n_frames))
            self._fh.seek(20)
            self._fh.write(struct.pack("<i", self.n_frames * self.interval))
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_dcd(path):
    """Minimal DCD reader: (frames [F, N, 3] nm, cells [F, 6] or None).
    Round-trip counterpart of DCDWriter (tests / quick analysis)."""
    import struct

    with open(path, "rb") as fh:
        raw = fh.read()

    off = [0]

    def rec():
        (n,) = struct.unpack_from("<i", raw, off[0])
        data = raw[off[0] + 4:off[0] + 4 + n]
        (n2,) = struct.unpack_from("<i", raw, off[0] + 4 + n)
        if n2 != n:
            raise ValueError("corrupt DCD record markers")
        off[0] += 8 + n
        return data

    hdr = rec()
    if hdr[:4] != b"CORD":
        raise ValueError("not a DCD file")
    ic = struct.unpack_from("<20i", hdr, 4)
    nframes, with_cell = ic[0], bool(ic[10])
    rec()                                   # titles
    (natoms,) = struct.unpack("<i", rec())
    frames, cells = [], []
    for _ in range(nframes):
        if with_cell:
            cells.append(np.frombuffer(rec(), "<f8"))
        xyz = [np.frombuffer(rec(), "<f4") for _ in range(3)]
        frames.append(np.stack(xyz, axis=1))
    return (np.asarray(frames, np.float64) / 10.0,
            np.asarray(cells) if with_cell else None)
