"""
Periodic-cell geometry: conversions, wrapping, minimum image.

The reference leans on ASE for all of this (``ase.geometry.wrap_positions``
at amof/trajectory.py:285-303, ``get_cell_lengths_and_angles`` at
amof/rdf.py:74, ``set_cell``'s flexible cell-parameter handling at
amof/elastic/core.py:58-71). This module re-implements those semantics
standalone, in float64 on host; device (torch) variants used inside the
kernels live next to them in ``amof_tpu_torch.ops``.

Row-vector convention throughout (same as ASE): cell[i] is lattice
vector i, cartesian = fractional @ cell.
"""

from __future__ import annotations

import numpy as np

WRAP_EPS = 1e-7  # ASE wrap_positions eps — keeps exactly-half displacements stable


def cellpar_to_cell(cellpar) -> np.ndarray:
    """3x3 cell from (a, b, c, alpha, beta, gamma) with angles in degrees.

    Uses the standard orientation (a along x, b in the xy plane) — the same
    convention ASE applies when ``set_cell`` receives 6 parameters.
    """
    a, b, c, alpha, beta, gamma = [float(x) for x in cellpar]
    cos_alpha = 0.0 if abs(alpha - 90.0) < 1e-14 else np.cos(np.radians(alpha))
    cos_beta = 0.0 if abs(beta - 90.0) < 1e-14 else np.cos(np.radians(beta))
    if abs(gamma - 90.0) < 1e-14:
        cos_gamma, sin_gamma = 0.0, 1.0
    else:
        cos_gamma, sin_gamma = np.cos(np.radians(gamma)), np.sin(np.radians(gamma))
    cy = (cos_alpha - cos_beta * cos_gamma) / sin_gamma
    cz_sq = 1.0 - cos_beta**2 - cy**2
    if cz_sq < 0:
        raise ValueError(f"invalid cell parameters {cellpar}")
    return np.array([
        [a, 0.0, 0.0],
        [b * cos_gamma, b * sin_gamma, 0.0],
        [c * cos_beta, c * cy, c * np.sqrt(cz_sq)],
    ])


def cell_from_any(cell) -> np.ndarray:
    """Normalize any accepted cell description to a 3x3 float64 matrix.

    Accepts: 3x3 matrix, 3 lengths (orthorhombic), or 6 cell parameters —
    the forms ASE ``set_cell`` handles (parity: amof/elastic/core.py:58-71).
    """
    cell = np.asarray(cell, dtype=np.float64)
    if cell.shape == (3, 3):
        return cell
    if cell.shape == (3,):
        return np.diag(cell)
    if cell.shape == (6,):
        return cellpar_to_cell(cell)
    raise ValueError(f"cannot interpret cell of shape {cell.shape}")


def cell_lengths_and_angles(cell) -> np.ndarray:
    """(a, b, c, alpha, beta, gamma) with angles in degrees."""
    cell = np.asarray(cell, dtype=np.float64)
    lengths = np.linalg.norm(cell, axis=1)
    angles = np.empty(3)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        cosang = np.dot(cell[j], cell[k]) / (lengths[j] * lengths[k])
        angles[i] = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
    return np.concatenate([lengths, angles])


def volume(cell) -> float:
    """Cell volume |det(cell)|."""
    return float(abs(np.linalg.det(np.asarray(cell, dtype=np.float64))))


def min_widths(cell) -> np.ndarray:
    """Perpendicular widths of the cell along each lattice direction.

    width_i = V / |a_j x a_k| — the safe upper bound for round-based
    minimum-image correctness is half the smallest width.
    """
    cell = np.asarray(cell, dtype=np.float64)
    vol = abs(np.linalg.det(cell))
    widths = np.empty(3)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        widths[i] = vol / np.linalg.norm(np.cross(cell[j], cell[k]))
    return widths


def cart_to_frac(positions, cell) -> np.ndarray:
    """Cartesian -> fractional (row-vector convention)."""
    return np.asarray(positions, dtype=np.float64) @ np.linalg.inv(
        np.asarray(cell, dtype=np.float64)
    )


def frac_to_cart(frac, cell) -> np.ndarray:
    """Fractional -> cartesian."""
    return np.asarray(frac, dtype=np.float64) @ np.asarray(cell, dtype=np.float64)


def wrap_positions(positions, cell, center=(0.5, 0.5, 0.5), eps=WRAP_EPS) -> np.ndarray:
    """Wrap positions so fractional coords lie in [center-0.5, center+0.5).

    ASE-compatible (ase.geometry.wrap_positions with pbc=True), which the
    reference uses both for frame wrapping (amof/coordination/reduce.py:95)
    and — with center=(0,0,0) — for the minimum-image displacement
    decomposition feeding the MSD (amof/trajectory.py:285-303).
    """
    center = np.asarray(center, dtype=np.float64)
    frac = cart_to_frac(positions, cell)
    shifted = frac - (center - 0.5 - eps)
    shifted %= 1.0
    shifted += center - 0.5 - eps
    return frac_to_cart(shifted, cell)


def min_image_delta(delta, cell) -> np.ndarray:
    """Minimum-image displacement vectors (round-based).

    Exact for |delta| < min(min_widths(cell)) / 2 — the same regime the
    reference guarantees via its rmax='half_cell' rule (amof/rdf.py:74-79).
    """
    cell = np.asarray(cell, dtype=np.float64)
    frac = np.asarray(delta, dtype=np.float64) @ np.linalg.inv(cell)
    frac -= np.floor(frac + 0.5 + WRAP_EPS)
    return frac @ cell


def min_image_distance(p1, p2, cell) -> np.ndarray:
    """Minimum-image distance(s) between cartesian points."""
    d = min_image_delta(np.asarray(p2) - np.asarray(p1), cell)
    return np.linalg.norm(d, axis=-1)
