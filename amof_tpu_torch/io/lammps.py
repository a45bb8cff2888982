"""
LAMMPS file utilities: data-file reader, native dump reader, and
xyz-dump deduplication.

Behavior parity: amof/files/lammps.py:10-34 (dedup) and
amof/trajectory.py:62-94 (data-file reading with mass -> element
inference via nearest standard atomic weight). The native dump reader
covers the formats the reference reaches through ASE's any-format
``Trajectory.from_traj`` (amof/trajectory.py:38-60).
"""

from __future__ import annotations

import bisect
import logging
import os

import numpy as np

from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.data import elements
from amof_tpu_torch.io.xyz import _open, parse_index

logger = logging.getLogger(__name__)


def remove_duplicate_timesteps(filename):
    """Remove duplicate timesteps from a LAMMPS xyz dump in place.

    Frames are keyed by their 'Atoms.' comment line; later duplicates
    (including their preceding atom-count line) are dropped.
    """
    seen_lines = set()
    tmp = str(filename) + "_temp_rm_duplicates"
    with open(filename, "r") as fr, open(tmp, "w") as fw:
        previous = None
        write_to_file = True
        for line in fr:
            if line[0:5] == "Atoms":
                if line not in seen_lines:
                    write_to_file = True
                    seen_lines.add(line)
                else:
                    logger.info("Removing duplicate %s", line.strip("\n"))
                    write_to_file = False
            if write_to_file and previous is not None:
                fw.write(previous)
            previous = line
        if write_to_file:
            fw.write(previous)
    os.remove(filename)
    os.rename(tmp, filename)


def closest_atomic_number(mass: float) -> int:
    """Atomic number whose standard weight is closest to ``mass``.

    Mirrors the bisect-based nearest lookup at amof/trajectory.py:76-94.
    """
    masses = elements.atomic_masses
    order = [m for m in masses[1:]]  # sorted in practice up to transuranics
    # atomic masses are monotonically increasing for Z=1..83; use bisect
    pos = bisect.bisect_left(order, mass)
    if pos == 0:
        return 1
    if pos >= len(order):
        return len(order)
    before, after = order[pos - 1], order[pos]
    if after - mass < mass - before:
        return pos + 1
    return pos


# Columns after the atom id for each supported atom_style.
_STYLE_COLUMNS = {
    "atomic": ("type", "x", "y", "z"),
    "charge": ("type", "q", "x", "y", "z"),
    "full": ("mol", "type", "q", "x", "y", "z"),
    "molecular": ("mol", "type", "x", "y", "z"),
}


def read_lammps_data(filename, atom_style: str = "charge") -> Frame:
    """Read a LAMMPS data file into a Frame.

    Element identity is inferred from the Masses section by nearest
    standard atomic weight (reference semantics,
    amof/trajectory.py:62-74).
    """
    if atom_style not in _STYLE_COLUMNS:
        raise ValueError(f"unsupported atom_style {atom_style!r}")
    cols = _STYLE_COLUMNS[atom_style]

    with open(filename) as f:
        lines = [ln.split("#")[0].rstrip() for ln in f]

    xlo = xhi = ylo = yhi = zlo = zhi = 0.0
    xy = xz = yz = 0.0
    masses = {}
    atoms = []
    section = None
    i = 1  # skip title line
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        tokens = line.split()
        if line.endswith("xlo xhi"):
            xlo, xhi = float(tokens[0]), float(tokens[1])
        elif line.endswith("ylo yhi"):
            ylo, yhi = float(tokens[0]), float(tokens[1])
        elif line.endswith("zlo zhi"):
            zlo, zhi = float(tokens[0]), float(tokens[1])
        elif line.endswith("xy xz yz"):
            xy, xz, yz = float(tokens[0]), float(tokens[1]), float(tokens[2])
        elif tokens[0] in ("Masses", "Atoms", "Velocities", "Bonds", "Angles",
                           "Dihedrals", "Impropers", "Pair", "PairIJ", "Bond",
                           "Angle", "Dihedral", "Improper"):
            section = tokens[0]
        elif section == "Masses" and len(tokens) >= 2 and tokens[0].isdigit():
            masses[int(tokens[0])] = float(tokens[1])
        elif section == "Atoms" and tokens and tokens[0].lstrip("-").isdigit():
            atoms.append(tokens)

    if not atoms:
        raise ValueError(f"no Atoms section found in {filename}")

    type_col = cols.index("type") + 1
    x_col = cols.index("x") + 1
    atoms.sort(key=lambda t: int(t[0]))
    types = np.array([int(t[type_col]) for t in atoms])
    positions = np.array(
        [[float(t[x_col]), float(t[x_col + 1]), float(t[x_col + 2])] for t in atoms]
    )
    numbers = np.array([closest_atomic_number(masses[t]) for t in types])
    cell = np.array([
        [xhi - xlo, 0.0, 0.0],
        [xy, yhi - ylo, 0.0],
        [xz, yz, zhi - zlo],
    ])
    positions -= np.array([xlo, ylo, zlo])
    return Frame(positions, numbers, cell, pbc=True)


# Position-column conventions of `dump custom`, in lookup priority
# (wrapped > scaled > unwrapped > scaled-unwrapped, ASE's order).
_POS_COLUMN_SETS = (
    (("x", "y", "z"), False),
    (("xs", "ys", "zs"), True),
    (("xu", "yu", "zu"), False),
    (("xsu", "ysu", "zsu"), True),
)


def _dump_cell_and_origin(bounds_lines, tilted):
    """Cell matrix + origin from an 'ITEM: BOX BOUNDS' block.

    LAMMPS stores xlo_bound/xhi_bound extended by the tilt factors; the
    true edges are recovered per the LAMMPS "triclinic boxes" howto.
    """
    rows = [np.fromstring(ln, sep=" ") for ln in bounds_lines]
    xy = xz = yz = 0.0
    if tilted:
        xy, xz, yz = rows[0][2], rows[1][2], rows[2][2]
    xlo = rows[0][0] - min(0.0, xy, xz, xy + xz)
    xhi = rows[0][1] - max(0.0, xy, xz, xy + xz)
    ylo = rows[1][0] - min(0.0, yz)
    yhi = rows[1][1] - max(0.0, yz)
    zlo, zhi = rows[2][0], rows[2][1]
    cell = np.array([
        [xhi - xlo, 0.0, 0.0],
        [xy, yhi - ylo, 0.0],
        [xz, yz, zhi - zlo],
    ])
    return cell, np.array([xlo, ylo, zlo])


def _parse_dump_frame(f, specorder):
    """Parse one 'ITEM: TIMESTEP'-headed frame; None at EOF."""
    line = f.readline()
    while line and not line.startswith("ITEM: TIMESTEP"):
        line = f.readline()
    if not line:
        return None
    step = int(f.readline().split()[0])
    line = f.readline()  # ITEM: NUMBER OF ATOMS
    if not line.startswith("ITEM: NUMBER OF ATOMS"):
        raise ValueError(f"malformed dump: expected NUMBER OF ATOMS, got {line!r}")
    n = int(f.readline().split()[0])
    line = f.readline()
    if not line.startswith("ITEM: BOX BOUNDS"):
        raise ValueError(f"malformed dump: expected BOX BOUNDS, got {line!r}")
    tilted = "xy" in line
    cell, origin = _dump_cell_and_origin(
        [f.readline() for _ in range(3)], tilted
    )
    line = f.readline()
    if not line.startswith("ITEM: ATOMS"):
        raise ValueError(f"malformed dump: expected ATOMS, got {line!r}")
    cols = line.split()[2:]
    col_idx = {name: i for i, name in enumerate(cols)}
    for names, scaled in _POS_COLUMN_SETS:
        if all(nm in col_idx for nm in names):
            pos_cols = [col_idx[nm] for nm in names]
            break
    else:
        raise ValueError(f"dump has no position columns among {cols}")

    rows = [f.readline().split() for _ in range(n)]
    if "id" in col_idx:
        rows.sort(key=lambda t: int(t[col_idx["id"]]))
    positions = np.array(
        [[float(t[c]) for c in pos_cols] for t in rows], dtype=np.float64
    )
    if scaled:
        positions = positions @ cell
    else:
        positions -= origin

    if "element" in col_idx:
        numbers = np.array(
            [elements.atomic_numbers[t[col_idx["element"]]] for t in rows]
        )
    elif "type" in col_idx:
        types = np.array([int(t[col_idx["type"]]) for t in rows])
        if specorder is not None:
            table = [
                elements.atomic_numbers[s] if isinstance(s, str) else int(s)
                for s in specorder
            ]
            numbers = np.array([table[t - 1] for t in types])
        else:
            numbers = types  # reference users attach identity via masses/specorder
    else:
        raise ValueError(f"dump has neither 'element' nor 'type' among {cols}")
    frame = Frame(positions, numbers, cell, pbc=True)
    frame.step = step
    return frame


def iread_lammps_dump(filename, specorder=None):
    """Yield Frames from a native LAMMPS text dump (``dump atom`` /
    ``dump custom``), one at a time. Handles orthogonal and triclinic
    boxes, wrapped/scaled/unwrapped coordinates, gzip.

    ``specorder`` maps LAMMPS type 1..T to element symbols/numbers;
    without it and without an ``element`` column, atomic numbers are
    the raw LAMMPS types (caller's contract to relabel).
    """
    with _open(filename) as f:
        while True:
            frame = _parse_dump_frame(f, specorder)
            if frame is None:
                return
            yield frame


def read_lammps_dump(filename, index=None, specorder=None):
    """Read frame(s) from a native LAMMPS dump; int index -> Frame,
    else list of Frames."""
    idx = parse_index(index)
    frames = list(iread_lammps_dump(filename, specorder))
    return frames[idx]
