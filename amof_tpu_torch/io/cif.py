"""
Minimal CIF reader/writer (P1).

The reference writes CIF frames as Zeo++ input via ASE
(amof/pore/core.py:92-93). amof_tpu_torch's pore engine is in-process, but
CIF stays useful for interop with external crystallography tools, so a
standalone P1 reader/writer is provided: cell parameters + fractional
atom sites (no symmetry expansion — symmetry-reduced files raise).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from amof_tpu_torch.core import cellmath
from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.data import elements


def write_cif(filename, frame: Frame, data_name="amof_tpu_torch"):
    """Write a frame as a P1 CIF with fractional coordinates."""
    a, b, c, alpha, beta, gamma = frame.get_cell_lengths_and_angles()
    frac = cellmath.cart_to_frac(frame.positions, frame.cell)
    frac -= np.floor(frac)
    symbols = frame.get_chemical_symbols()
    with open(filename, "w") as f:
        f.write(f"data_{data_name}\n")
        f.write(f"_cell_length_a {a:.6f}\n")
        f.write(f"_cell_length_b {b:.6f}\n")
        f.write(f"_cell_length_c {c:.6f}\n")
        f.write(f"_cell_angle_alpha {alpha:.6f}\n")
        f.write(f"_cell_angle_beta {beta:.6f}\n")
        f.write(f"_cell_angle_gamma {gamma:.6f}\n")
        f.write("_symmetry_space_group_name_H-M 'P 1'\n")
        f.write("_symmetry_Int_Tables_number 1\n")
        f.write("loop_\n")
        f.write("_atom_site_label\n")
        f.write("_atom_site_type_symbol\n")
        f.write("_atom_site_fract_x\n")
        f.write("_atom_site_fract_y\n")
        f.write("_atom_site_fract_z\n")
        for i, (sym, (x, y, z)) in enumerate(zip(symbols, frac)):
            f.write(f"{sym}{i + 1} {sym} {x:.6f} {y:.6f} {z:.6f}\n")


_NUM = re.compile(r"(-?\d+\.?\d*(?:[eE][+-]?\d+)?)")


def _cif_number(token: str) -> float:
    """Parse a CIF numeric token, dropping '(esd)' suffixes."""
    return float(_NUM.match(token).group(1))


def read_cif(filename) -> Frame:
    """Read a P1 CIF into a Frame (no symmetry expansion)."""
    cellpar = {}
    rows: List[List[str]] = []
    columns: List[str] = []
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    i = 0
    while i < len(lines):
        line = lines[i]
        low = line.lower()
        if low.startswith("_cell_length_a"):
            cellpar["a"] = _cif_number(line.split()[1])
        elif low.startswith("_cell_length_b"):
            cellpar["b"] = _cif_number(line.split()[1])
        elif low.startswith("_cell_length_c"):
            cellpar["c"] = _cif_number(line.split()[1])
        elif low.startswith("_cell_angle_alpha"):
            cellpar["alpha"] = _cif_number(line.split()[1])
        elif low.startswith("_cell_angle_beta"):
            cellpar["beta"] = _cif_number(line.split()[1])
        elif low.startswith("_cell_angle_gamma"):
            cellpar["gamma"] = _cif_number(line.split()[1])
        elif low.startswith("_symmetry_space_group") or low.startswith(
            "_space_group_name"
        ):
            if "P 1" not in line and "P1" not in line:
                raise ValueError(
                    "only P1 CIFs are supported (no symmetry expansion)"
                )
        elif low == "loop_":
            j = i + 1
            loop_cols = []
            while j < len(lines) and lines[j].startswith("_"):
                loop_cols.append(lines[j].lower())
                j += 1
            if any(c.startswith("_atom_site") for c in loop_cols):
                columns = loop_cols
                while j < len(lines) and not lines[j].startswith(
                    ("_", "loop_", "data_")
                ):
                    rows.append(lines[j].split())
                    j += 1
            i = j - 1
        i += 1

    if not rows or not cellpar:
        raise ValueError(f"no P1 atom sites found in {filename}")
    cell = cellmath.cellpar_to_cell(
        [cellpar[k] for k in ("a", "b", "c", "alpha", "beta", "gamma")]
    )

    def col(name):
        return columns.index(name)

    try:
        sym_col = col("_atom_site_type_symbol")
    except ValueError:
        sym_col = col("_atom_site_label")
    fx, fy, fz = (col(f"_atom_site_fract_{ax}") for ax in "xyz")
    numbers, frac = [], []
    for row in rows:
        sym = re.match(r"[A-Za-z]{1,2}", row[sym_col]).group(0)
        sym = sym[0].upper() + sym[1:].lower()
        numbers.append(elements.atomic_numbers[sym])
        frac.append([_cif_number(row[fx]), _cif_number(row[fy]),
                     _cif_number(row[fz])])
    positions = cellmath.frac_to_cart(np.array(frac), cell)
    return Frame(positions, numbers, cell, pbc=True)
