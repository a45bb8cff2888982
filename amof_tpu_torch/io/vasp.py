"""
VASP POSCAR/CONTCAR and XDATCAR readers.

Part of the general-format trajectory reading the reference gets for
free from ASE's ``ase.io.read`` in ``Trajectory.from_traj``
(amof/trajectory.py:38-60); implemented standalone here. Handles the
VASP-5 symbol line, scaling factor, Direct/Cartesian coordinates,
Selective dynamics, and (for XDATCAR) both fixed-cell and NpT
variable-cell trajectories. Gzip transparent.
"""

from __future__ import annotations

import numpy as np

from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.data import elements
from amof_tpu_torch.io.xyz import _open, parse_index


def _read_cell_block(lines, i):
    """(scale, cell, next_index) from lines[i:]: scale + 3 lattice rows."""
    scale = float(lines[i].split()[0])
    cell = np.array(
        [np.fromstring(lines[i + 1 + k], sep=" ")[:3] for k in range(3)]
    )
    if scale < 0:  # negative scale = target cell volume (VASP convention)
        scale = (-scale / abs(np.linalg.det(cell))) ** (1.0 / 3.0)
    return scale, cell * scale, i + 4


def _read_species_counts(lines, i):
    """(numbers_per_site, next_index) from the symbol+count lines."""
    tokens = lines[i].split()
    if tokens and not tokens[0].isdigit():  # VASP-5 symbol line
        symbols = tokens
        counts = [int(t) for t in lines[i + 1].split()]
        i += 2
    else:
        raise ValueError(
            "VASP-4 POSCAR without a symbol line carries no element "
            "identity; add the VASP-5 symbol line"
        )
    numbers = np.concatenate([
        np.full(c, elements.atomic_numbers[s], dtype=np.int64)
        for s, c in zip(symbols, counts)
    ])
    return numbers, i


def read_poscar(filename) -> Frame:
    """Read a POSCAR/CONTCAR file into a Frame."""
    with _open(filename) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    _, cell, i = _read_cell_block(lines, 1)
    numbers, i = _read_species_counts(lines, i)
    if lines[i].lstrip()[:1].lower() == "s":  # Selective dynamics
        i += 1
    # VASP semantics: Cartesian only when the line starts with C/c/K/k;
    # ANY other marker means Direct (not just 'd')
    direct = lines[i].lstrip()[:1].lower() not in ("c", "k")
    i += 1
    coords = np.array([
        np.fromstring(lines[i + k], sep=" ")[:3] for k in range(len(numbers))
    ])
    positions = coords @ cell if direct else coords
    return Frame(positions, numbers, cell, pbc=True)


def read_xdatcar(filename, index=None):
    """Read an XDATCAR trajectory; int index -> Frame, else list.

    Supports both the fixed-cell layout (header once, then repeated
    ``Direct configuration= N`` blocks) and the NpT layout where the
    full header repeats before every configuration.
    """
    with _open(filename) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    frames = []
    i = 0
    cell = None
    numbers = None
    while i < len(lines):
        low = lines[i].lstrip().lower()
        if low.startswith("direct configuration") or low.startswith("direct"):
            if cell is None or numbers is None:
                raise ValueError(f"XDATCAR configuration before header in {filename}")
            i += 1
            coords = np.array([
                np.fromstring(lines[i + k], sep=" ")[:3]
                for k in range(len(numbers))
            ])
            i += len(numbers)
            frames.append(Frame(coords @ cell, numbers, cell, pbc=True))
        else:
            # (repeated) header: comment, scale, 3x lattice, symbols, counts
            _, cell, i = _read_cell_block(lines, i + 1)
            numbers, i = _read_species_counts(lines, i)
    return frames[parse_index(index)]
