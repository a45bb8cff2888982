"""
XYZ / extended-XYZ trajectory reader.

Standalone replacement for the ``ase.io.read`` xyz path the reference
relies on (amof/trajectory.py:38-60). Supports:

  - plain XYZ (symbol x y z per line) and extended XYZ with a
    ``Lattice="ax ay az bx ... cz"`` comment and a ``Properties=`` spec
    (the format of examples/files/ZIF-4.xyz in the reference);
  - multi-frame files;
  - ASE-style frame selection: int, slice, 'first:last:step' strings,
    ':' for all frames;
  - transparent gzip (filename ending in .gz).
"""

from __future__ import annotations

import gzip
import re
from typing import List, Optional, Union

import numpy as np

from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.data import elements

_LATTICE_RE = re.compile(r'Lattice="([^"]+)"')
_PROPS_RE = re.compile(r"Properties=(\S+)")


def parse_index(index) -> Union[int, slice]:
    """Normalize ASE-style index ('1:10:2', ':', slice, int, None)."""
    if index is None:
        return slice(None)
    if isinstance(index, (int, np.integer)):
        return int(index)
    if isinstance(index, slice):
        return index
    if isinstance(index, str):
        parts = index.split(":")
        if len(parts) == 1:
            return int(parts[0])
        vals = [int(p) if p.strip() else None for p in parts]
        while len(vals) < 3:
            vals.append(None)
        return slice(*vals[:3])
    raise ValueError(f"cannot interpret index {index!r}")


def _open(filename):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename)


def _species_pos_columns(props: Optional[str]):
    """Column offsets of species and positions from a Properties spec."""
    if props is None:
        return 0, 1
    fields = props.split(":")
    col = 0
    sp_col, pos_col = 0, 1
    for i in range(0, len(fields), 3):
        name, _kind, width = fields[i], fields[i + 1], int(fields[i + 2])
        if name == "species":
            sp_col = col
        elif name == "pos":
            pos_col = col
        col += width
    return sp_col, pos_col


def _parse_frame(lines: List[str]) -> Frame:
    comment = lines[1]
    m = _LATTICE_RE.search(comment)
    cell = None
    if m:
        vals = np.fromstring(m.group(1), sep=" ")
        cell = vals.reshape(3, 3)
    pm = _PROPS_RE.search(comment)
    sp_col, pos_col = _species_pos_columns(pm.group(1) if pm else None)

    n = int(lines[0].split()[0])
    numbers = np.empty(n, dtype=np.int64)
    positions = np.empty((n, 3), dtype=np.float64)
    for i in range(n):
        tokens = lines[2 + i].split()
        sp = tokens[sp_col]
        numbers[i] = (
            int(sp) if sp.lstrip("-").isdigit() else elements.atomic_numbers[sp]
        )
        positions[i] = [float(tokens[pos_col + k]) for k in range(3)]
    return Frame(positions, numbers, cell, pbc=cell is not None)


def iread_xyz(filename):
    """Yield frames from an (ext)xyz file one at a time."""
    with _open(filename) as f:
        while True:
            header = f.readline()
            if not header or not header.strip():
                return
            n = int(header.split()[0])
            lines = [header, f.readline()]
            for _ in range(n):
                lines.append(f.readline())
            yield _parse_frame(lines)


def read_xyz(filename, index=None):
    """Read frames from an (ext)xyz file.

    Returns a single Frame for an int index, else a list of Frames.
    """
    idx = parse_index(index)
    if isinstance(idx, int) and idx >= 0:
        for i, frame in enumerate(iread_xyz(filename)):
            if i == idx:
                return frame
        raise IndexError(f"frame {idx} not in {filename}")
    frames = list(iread_xyz(filename))
    if isinstance(idx, int):
        return frames[idx]
    return frames[idx]
