"""
The void-mask and surface-blocker passes of the batched pore step as
hand-written CUDA kernels, with their plain PyTorch versions.

Counterpart of ``amof_tpu/pore/surface_kernel.py``:

  * ``void_masks_points`` replaces ``void_masks_points_pallas`` (kernel
    #5, ``csrc/void_masks.cu``): per xy tile, the probe and channel voxel
    masks ``d2 >= (R_j + thr)^2`` over the tile's three candidate runs,
    and the MC point fits over the same candidates; the kernel runs one
    block per (tile, z slab) and skips the rows provably beyond z reach
    of the slab (plain twin of that cut:
    ``grid_kernel.void_masks_z_window``);
  * ``surface_valid_columns`` replaces ``surface_valid_columns_pallas``
    (kernel #6, ``csrc/surface_columns.cu``): per slot of ``chunk``
    column-sorted centers holding a candidate atom, the K sphere points'
    validity against the column's blocker runs, and their voxel indices;
    the kernel takes groups of consecutive centers and stages only the
    blocker rows that can reach the group's points in z (plain twin of
    that cut: ``grid_kernel.surface_z_window``).

Each wrapper builds the sorted layout in torch (``grid_kernel``'s
``masks_layout`` / ``surface_layout``), checks its inputs, and launches
the kernel for CUDA tensors or runs the plain version
(``grid_kernel.void_masks_tiles_plain`` / ``surface_valid_tiles_plain``)
for CPU tensors; there is no fallback between the two. The TPU kernels'
128-aligned window starts, extra segment, dead pad rows, 128-atom slot
chunks and VMEM scratch have no counterpart: the kernels read exactly the
rows of each run, so a run's end is never overrun.
"""

from __future__ import annotations

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.pore import grid_kernel

_F32 = torch.float32


def _check(tensors, shapes_dtypes):
    dev = tensors[0].device
    for t, (name, shape, dtype) in zip(tensors, shapes_dtypes):
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def void_masks_points(frac_atoms, cell, radii, grid, probe: float,
                      chan: float, nbx: int, nby: int, window: int,
                      pts_tiled=None):
    """Kernel #5: (mask_probe bool[gx, gy, gz], mask_chan, fit_pts
    bool[T, P] or None, missed bool[]) -- the contract of
    ``amof_tpu``'s ``void_masks_points_pallas`` and of the plain
    ``grid_kernel.void_masks_columns``."""
    if grid[0] % nbx or grid[1] % nby:
        raise ValueError("xy columns must tile the grid")
    n = frac_atoms.shape[0]
    n_tiles = nbx * nby
    checks = [(frac_atoms, ("frac_atoms", (n, 3), _F32)),
              (cell, ("cell", (3, 3), _F32)),
              (radii, ("radii", (n,), _F32))]
    if pts_tiled is not None:
        checks.append((pts_tiled, ("pts_tiled", None, _F32)))
        if pts_tiled.dim() != 3 or pts_tiled.shape[0] != n_tiles \
                or pts_tiled.shape[2] != 3:
            raise ValueError("pts_tiled must be f32 [nbx*nby, P, 3]")
    _check(*zip(*checks))
    lay = grid_kernel.masks_layout(frac_atoms, radii, nbx, nby, window)
    thr_hi, thr_lo, thr_fit = grid_kernel.mask_thresholds(probe, chan)
    if frac_atoms.device.type == "cpu":
        hi, lo, fit = grid_kernel.void_masks_tiles_plain(
            lay, cell, grid, nbx, nby, window, thr_hi, thr_lo, thr_fit,
            pts_tiled)
    else:
        hi, lo, fit = _launch_masks(lay, cell, grid, nbx, nby, window,
                                    thr_hi, thr_lo, thr_fit, pts_tiled)
    m_probe, m_chan = (hi, lo) if probe >= chan else (lo, hi)
    return m_probe, m_chan, fit, lay.missed


def _launch_masks(lay, cell, grid, nbx, nby, window, thr_hi, thr_lo,
                  thr_fit, pts_tiled):
    from amof_tpu_torch import _build

    dev = cell.device
    two = thr_hi != thr_lo
    hi = torch.empty(grid, dtype=torch.bool, device=dev)
    lo = torch.empty_like(hi) if two else hi
    n_pts = 0 if pts_tiled is None else pts_tiled.shape[1]
    fit = (torch.empty((nbx * nby, n_pts), dtype=torch.bool, device=dev)
           if pts_tiled is not None else None)
    err = _build.library().void_masks_launch(
        lay.payload.data_ptr(), lay.payload.shape[1], lay.keys.data_ptr(),
        lay.cstarts.data_ptr(), window, cell.data_ptr(), *grid, nbx, nby,
        thr_hi, thr_lo, thr_fit, int(two),
        0 if pts_tiled is None else pts_tiled.data_ptr(), n_pts,
        hi.data_ptr(), lo.data_ptr(), 0 if fit is None else fit.data_ptr(),
        _build.stream_ptr(cell))
    _build.check(err, "void_masks_points")
    tracing.count("launch.void_masks_points")  # CPU calls do not count
    return hi, lo, fit


def surface_valid_columns(frac_atoms, cell, radii, r_probe, dirs, grid,
                          nbx: int, nby: int, window: int, chunk: int,
                          col_cap: int, cand_mask=None, inv_cell=None):
    """Kernel #6: (valid bool[N, K], idx_pt i32[N, K], idx_nudge i32[N, K],
    orig_idx i32[N], radii f32[N], missed bool[]) -- the contract of
    ``amof_tpu``'s ``surface_valid_columns_pallas`` and of the plain
    ``grid_kernel.surface_valid_columns``, one row per atom in the
    layout's center order."""
    n = frac_atoms.shape[0]
    k = dirs.shape[0]
    if inv_cell is None:
        inv_cell = grid_kernel.host_inverse(cell)
    checks = [(frac_atoms, ("frac_atoms", (n, 3), _F32)),
              (cell, ("cell", (3, 3), _F32)),
              (inv_cell, ("inv_cell", (3, 3), _F32)),
              (radii, ("radii", (n,), _F32)),
              (dirs, ("dirs", (k, 3), _F32))]
    if cand_mask is not None:
        checks.append((cand_mask, ("cand_mask", tuple(grid), torch.bool)))
    _check(*zip(*checks))
    lay = grid_kernel.surface_layout(frac_atoms, inv_cell, radii, r_probe,
                                     dirs, grid, nbx, nby, window, col_cap,
                                     cand_mask)
    n_z = -(-col_cap // chunk)
    if frac_atoms.device.type == "cpu":
        valid, i_pt, i_nu = grid_kernel.surface_valid_tiles_plain(
            lay, cell, inv_cell, dirs, r_probe, grid, nbx, nby, window,
            n_z, chunk)
    else:
        valid, i_pt, i_nu = _launch_surface(lay, cell, inv_cell, dirs,
                                            r_probe, grid, nbx, nby, n_z,
                                            chunk)
    return (valid, i_pt, i_nu, lay.centers[4].to(torch.int32),
            lay.centers[3], lay.missed)


def _launch_surface(lay, cell, inv_cell, dirs, r_probe, grid, nbx, nby,
                    n_z, chunk):
    """Kernel #6 on a prepared layout. The kernel writes every row of its
    outputs in the same launch, so nothing is cleared first: the rows of
    its groups, and False / 0 in every other row (inactive slots, rows
    past ``n_z * chunk`` of a column, rows outside every column)."""
    from amof_tpu_torch import _build

    dev = cell.device
    n = lay.centers.shape[1]
    k = dirs.shape[0]
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    i_pt = torch.empty((n, k), dtype=torch.int32, device=dev)
    i_nu = torch.empty((n, k), dtype=torch.int32, device=dev)
    rp = float(np.float32(r_probe))
    peps = float(np.float32(r_probe) - np.float32(1e-4))
    err = _build.library().surface_columns_launch(
        lay.centers.data_ptr(), n, lay.c_bounds.data_ptr(),
        lay.cand_end.data_ptr(), nbx * nby, n_z, chunk,
        grid_kernel.surface_group_size(k), lay.blockers.data_ptr(),
        lay.blockers.shape[1], lay.b_start.data_ptr(),
        lay.b_count.data_ptr(), nbx, nby, cell.data_ptr(), inv_cell.data_ptr(),
        dirs.data_ptr(), lay.nudge.data_ptr(), k, rp, peps, *grid,
        valid.data_ptr(), i_pt.data_ptr(), i_nu.data_ptr(),
        _build.stream_ptr(cell))
    _build.check(err, "surface_valid_columns")
    tracing.count("launch.surface_valid_columns")  # CPU calls do not count
    return valid, i_pt, i_nu


def surface_columns_geometry(n_cols: int) -> dict:
    """What kernel #6's launch gets for ``n_cols`` columns on the current
    card: blocks (the persistent grid), threads, smem_bytes (static and
    dynamic), registers, blocks_per_sm and cap_rows (rows one flush of the
    staging holds), as the CUDA source computes them."""
    import ctypes

    from amof_tpu_torch import _build

    geo = (ctypes.c_int * 6)()
    _build.check(_build.library().surface_columns_geometry(n_cols, geo),
                 "surface_columns_geometry")
    keys = ("blocks", "threads", "smem_bytes", "registers", "blocks_per_sm",
            "cap_rows")
    return dict(zip(keys, geo))
