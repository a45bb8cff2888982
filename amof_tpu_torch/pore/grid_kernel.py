"""
Pore geometry: host planning, the sorted atom layouts, the plain PyTorch
versions of the void-mask and surface kernels, the connectivity chain,
the distance fields and the per-frame path's sampling.

Counterpart of ``amof_tpu/pore/grid_kernel.py``:

  * numpy planning, copied: ``fibonacci_sphere``, ``xycol_plan``,
    ``surface_plan``, ``assign_points_to_xytiles``;
  * the sorted layouts in torch: ``_sort_atoms_xycols`` (atoms bucketed
    into xy columns, y-edge rows duplicated so every 3x3 column
    neighbourhood is three contiguous runs), ``masks_layout`` and
    ``surface_layout``;
  * the plain versions of kernels #5 and #6: ``void_masks_columns`` and
    ``surface_valid_columns`` (their CUDA wrappers live in
    ``pore/surface_kernel.py``), and ``void_masks_z_window``, the plain
    twin of #5's z-slab candidate cut, which the tests hold against the
    full candidate set;
  * the connectivity chain ``label_components`` -> ``winding_seeds`` ->
    ``propagate_channel`` -> ``void_classification_mask``, all through
    ``propagate_fixpoint``: kernel #7 (``csrc/flood_fill.cu``, union-find
    labelling) for CUDA tensors, roll-based masked max sweeps to a
    fixpoint for CPU tensors;
  * ``surface_candidate_mask``, ``classify_surface_points``,
    ``grid_lookup``;
  * for the per-frame path (``zeopp``) and ``BatchedPore``'s
    distance-field plans, in torch on the caller's device: the distance
    fields (``distance_grid``, the sorted-window ``distance_grid_windowed``
    and two-level ``distance_grid_windowed2``, ``point_distance_windowed``
    at MC points), ``void_classification``, ``face_label_pairs``,
    ``percolating_flags``, ``dilate``, the per-atom surface sampling
    (``surface_point_classification`` and its windowed form), the
    covering-sphere PSD by FFT (``covering_volume_counts``) and the ray
    march (``ray_chord_lengths``).

Every threshold test compares squared distances in the reference's
expression order; divisions by a count use a device tensor as divisor
(CUDA turns a division by a host scalar into a reciprocal multiply).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.core.cellmath import cell_widths
from amof_tpu_torch.ops.pair_engine import matvec3, sqrt_rn, squared_norm

_F32 = torch.float32
_I32 = torch.int32


def _div(x, d):
    """x / d with ``d`` as a device tensor: an IEEE division on every
    device (CUDA divides by a host scalar as a reciprocal multiply)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _wrap01(x):
    return x - torch.floor(x)


def host_inverse(cell: torch.Tensor) -> torch.Tensor:
    """float32 inverse of one cell [3, 3] or a stack [F, 3, 3]: the
    float64 inverse rounded once, computed on the CPU so the card and the
    CPU see the same bits. ``amof_tpu`` inverts in float32 per frame
    (``jnp.linalg.inv``); the two agree exactly where the inverse is
    representable (power-of-two diagonals with dyadic shears) and within
    a float32 ulp or two elsewhere."""
    inv = torch.linalg.inv(cell.detach().to("cpu", torch.float64))
    return inv.to(_F32).contiguous().to(cell.device)


# --------------------------------------------------------------------------
# Host planning (numpy)
# --------------------------------------------------------------------------

def fibonacci_sphere(n: int) -> np.ndarray:
    """n quasi-uniform unit vectors (deterministic surface sampling)."""
    i = np.arange(n) + 0.5
    phi = np.pi * (1 + 5**0.5) * i
    cos_t = 1 - 2 * i / n
    sin_t = np.sqrt(np.maximum(0, 1 - cos_t**2))
    return np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=-1
    ).astype(np.float32)


def ceil128(x: float) -> int:
    """``x`` rounded up to a multiple of 128 (a sorted window's width)."""
    return int(-(-x // 128) * 128)


def window_sizes(cells, radii_max: float, n_atoms: int, grid, dmax: float,
                 probe: float, window="auto", scale: float = 1.0):
    """Sorted-window sizes of the distance field and of the surface
    classification, conservative over ``cells`` (the smallest x width):
    (dxa, dist_window, surf_window). ``dxa`` is the field's fractional-x
    reach, rounded up to 5e-3 so that it stays the same across NPT
    frames. ``window`` "auto" sizes the field's window from the density,
    an int forces it (times ``scale``), None gives neither window; a
    window that would reach every atom is None."""
    w0 = cell_widths(cells)[0]
    dxa = float(np.ceil((dmax + radii_max) / w0 / 5e-3) * 5e-3)
    if window is None:
        return dxa, None, None
    chunk = 2048  # pessimistic span for the adaptive chunk
    span = (chunk // (grid[1] * grid[2]) + 2) / grid[0]
    if window == "auto":
        dist_window = ceil128((1.3 * n_atoms * (span + 2 * dxa) + 64)
                              * scale)
    else:
        dist_window = int(window * scale)
    # blockers lie within R_i + R_j + 2 * probe of a centre
    reach = 2.0 * (radii_max + probe)
    surf_window = ceil128((1.3 * n_atoms * reach / w0 + 64) * scale)
    return (dxa, dist_window if dist_window < n_atoms else None,
            surf_window if 32 + 2 * surf_window < n_atoms else None)


def xycol_plan(cells, radii_max, dmax, grid_raw, n_atoms):
    """Static plan for the xy-column mask pass.

    Returns dict(grid, nbx, nby, window, n_zc, wz, wzw, zmargin) or None
    when the cell is too small for >= 4x4 reach-wide columns (or three
    windows would cover every atom). Grid x/y dims are rounded so columns
    tile them exactly. The z-window fields (n_zc, wz, wzw, zmargin) are
    kept for parity with ``amof_tpu``; kernel #5 does not read them: it
    cuts z into slabs of its own height (``VOID_SLAB`` voxels).
    """
    widths = cell_widths(cells)
    reach = float(dmax + radii_max)
    nbx = int(widths[0] / reach)
    nby = int(widths[1] / reach)
    if nbx < 4 or nby < 4:
        return None

    def round_axis(g_raw, nb_max):
        """(g, nb): smallest g >= g_raw with g = nb * tv, nb <= nb_max,
        and g % 8 == 0."""
        best = None
        for nb in range(nb_max, 3, -1):
            tv = -(-g_raw // nb)
            for bump in range(8):
                g = nb * (tv + bump)
                if g % 8 == 0:
                    if best is None or g < best[0]:
                        best = (g, nb)
                    break
        if best is None:  # fall back to even dims
            nb = nb_max
            tv = -(-g_raw // nb)
            tv += tv % 2
            return nb * tv, nb
        return best

    gx, nbx = round_axis(grid_raw[0], nbx)
    gy, nby = round_axis(grid_raw[1], nby)
    gz = -(-grid_raw[2] // 4) * 4
    # slice cap: 3 contiguous columns (plus y-edge duplicates); additive
    # Poisson tail margin
    mean3 = 3.0 * n_atoms / (nbx * nby) * (1.0 + 2.0 / nby)
    w_est = mean3 + 6.0 * np.sqrt(max(mean3, 1.0)) + 16
    window = int(-(-w_est // 8) * 8)
    if 3 * window >= n_atoms:
        return None

    def pad8(lam):
        return int(-((lam + 6.0 * np.sqrt(max(lam, 1.0)) + 16) // -8) * 8)

    zmargin = reach / widths[2]
    n_zc = max(
        (d for d in range(2, 9) if gz % d == 0 and d * zmargin < 1.0),
        default=0,
    )
    wz = wzw = 0
    if n_zc:
        wz = pad8(mean3 * (1.0 / n_zc + 2.0 * zmargin))
        wzw = pad8(mean3 * zmargin)
        if wz >= window or wz + wzw / n_zc > 0.8 * window:
            n_zc = 0
    return {"grid": (gx, gy, gz), "nbx": nbx, "nby": nby,
            "window": window, "n_zc": n_zc, "wz": wz, "wzw": wzw,
            "zmargin": float(zmargin) if n_zc else 0.0}


def surface_plan(cells, radii_max, probe, n_atoms, chunk: int = 64):
    """Static plan for ``surface_valid_columns``: coarse xy columns wide
    enough for the blocker reach R_i + R_j + 2*probe.

    Returns dict(nbx, nby, window, chunk, col_cap) or None when the cell
    is too small for >= 3 coarse columns per axis."""
    widths = cell_widths(cells)
    reach = float(2.0 * radii_max + 2.0 * probe)
    nbx = int(widths[0] / reach)
    nby = int(widths[1] / reach)
    if nbx < 3 or nby < 3:
        return None
    mean3 = 3.0 * n_atoms / (nbx * nby) * (1.0 + 2.0 / nby)
    w_est = mean3 + 6.0 * np.sqrt(max(mean3, 1.0)) + 16
    window = int(-(-w_est // 8) * 8)
    if 3 * window >= n_atoms:
        return None
    col_mean = n_atoms / (nbx * nby)
    cap_est = col_mean + 5.5 * np.sqrt(max(col_mean, 1.0)) + 8
    col_cap = int(-(-cap_est // chunk) * chunk)
    return {"nbx": nbx, "nby": nby, "window": window, "chunk": chunk,
            "col_cap": col_cap}


def assign_points_to_xytiles(pts, plan):
    """Host-side static assignment of sample points to xy-column tiles.

    Returns (pts_tiled f32[nbx*nby, P, 3], weights f32[nbx*nby, P]): P is
    the exact max tile occupancy; padding slots sit at the tile center
    with weight 0."""
    pts = np.asarray(pts, np.float32)
    nbx, nby = plan["nbx"], plan["nby"]
    ti = np.minimum((pts[:, 0] * nbx).astype(np.int64), nbx - 1)
    tj = np.minimum((pts[:, 1] * nby).astype(np.int64), nby - 1)
    tile = ti * nby + tj
    n_tiles = nbx * nby
    counts = np.bincount(tile, minlength=n_tiles)
    cap = int(counts.max())
    out = np.empty((n_tiles, cap, 3), np.float32)
    t_ids = np.arange(n_tiles)
    out[:, :, 0] = ((t_ids // nby) + 0.5)[:, None] / nbx
    out[:, :, 1] = ((t_ids % nby) + 0.5)[:, None] / nby
    out[:, :, 2] = 0.5
    w = np.zeros((n_tiles, cap), np.float32)
    order = np.argsort(tile, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for t in np.nonzero(counts)[0]:
        sel = order[starts[t]:starts[t + 1]]
        out[t, :counts[t]] = pts[sel]
        w[t, :counts[t]] = 1.0
    return out, w


# --------------------------------------------------------------------------
# Sorted layouts (torch)
# --------------------------------------------------------------------------

def _sort_atoms_xycols(frac_atoms, extra, nbx: int, nby: int):
    """Sort atoms by xy-column with y-edge duplication.

    Column key space is ``bx * (nby + 2) + (by + 1)``: atoms of row
    by == nby-1 are duplicated at shifted index 0 and atoms of by == 0 at
    shifted index nby+1, so any [by-1, by+1] query inside an x row is one
    contiguous run. Keys carry ``fz`` as their fraction; the sort is
    stable.

    Returns (keys f32[M], payload f32[3 + len(extra), M]) with payload
    rows (fx, fy, fz, *extra); duplicates keep their original coordinates.
    """
    fx = _wrap01(frac_atoms[:, 0])
    fy = _wrap01(frac_atoms[:, 1])
    fz = _wrap01(frac_atoms[:, 2])
    bx = torch.clamp((fx * nbx).to(_I32), max=nbx - 1)
    by = torch.clamp((fy * nby).to(_I32), max=nby - 1)
    stride = nby + 2
    key0 = (bx * stride + by + 1).to(_F32) + fz
    far = torch.full_like(fz, 3e9)
    key_lo = torch.where(by == nby - 1, (bx * stride).to(_F32) + fz, far)
    key_hi = torch.where(
        by == 0, (bx * stride + nby + 1).to(_F32) + fz, far)
    keys = torch.cat([key0, key_lo, key_hi])
    payload = torch.stack([torch.cat([c, c, c])
                           for c in [fx, fy, fz] + list(extra)])
    keys, order = torch.sort(keys, stable=True)
    return keys.contiguous(), payload[:, order].contiguous()


# A copy from host memory waits until the card has run everything queued
# before it, so the per-frame path reads its constants from these caches.
@functools.lru_cache(maxsize=64)
def _on_device(values: tuple, dtype, device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _neighbourhood_tensor(n_cols: int, nbx: int, nby: int, device):
    """``_neighbourhood_columns`` of every column, on ``device``, made
    once."""
    return torch.as_tensor(_neighbourhood_columns(np.arange(n_cols), nbx,
                                                  nby), device=device)


def _runs(cstarts, n_cols: int, nbx: int, nby: int, window: int):
    """(start i32[C, 3], rows to read i32[C, 3], missed bool[]) of the
    three runs [cstarts[c0], cstarts[c0 + 3]) of each of the ``n_cols``
    columns, c0 from ``_neighbourhood_columns``."""
    c0 = _neighbourhood_tensor(n_cols, nbx, nby, cstarts.device)
    st = cstarts[c0]
    en = cstarts[c0 + 3]
    missed = torch.any((en - st) > window)
    cnt = torch.clamp(en - st, max=window)
    return st.to(_I32).contiguous(), cnt.to(_I32).contiguous(), missed


def _neighbourhood_columns(cols: np.ndarray, nbx: int, nby: int):
    """Shifted-y start column of the three x rows around each column."""
    ci, cj = cols // nby, cols % nby
    return (((ci[:, None] + np.array([-1, 0, 1])[None, :]) % nbx)
            * (nby + 2) + cj[:, None])


class MaskLayout(NamedTuple):
    payload: torch.Tensor  # f32 [4, M]: fx, fy, fz, radius (column order)
    start: torch.Tensor    # i32 [T, 3]: first row of each run of a tile
    count: torch.Tensor    # i32 [T, 3]: rows of each run read (<= window)
    missed: torch.Tensor   # bool []: a run longer than ``window``
    keys: torch.Tensor     # f32 [M]: sort keys, shifted column + fz
    cstarts: torch.Tensor  # i64 [nbx * (nby + 2) + 1]: first row per column


def masks_layout(frac_atoms, radii, nbx: int, nby: int,
                 window: int) -> MaskLayout:
    """Candidate runs of every xy tile for the void-mask pass."""
    keys, payload = _sort_atoms_xycols(frac_atoms, [radii], nbx, nby)
    stride = nby + 2
    cstarts = torch.searchsorted(
        keys, torch.arange(nbx * stride + 1, dtype=_F32,
                           device=keys.device))
    st, cnt, missed = _runs(cstarts, nbx * nby, nbx, nby, window)
    return MaskLayout(payload, st, cnt, missed, keys, cstarts)


class SurfaceLayout(NamedTuple):
    centers: torch.Tensor   # f32 [5, N]: fx, fy, fz, radius, atom index
    c_bounds: torch.Tensor  # i32 [C + 1]: column ranges of ``centers``
    cand_end: torch.Tensor  # i32 [C]: end of each column's candidates
    blockers: torch.Tensor  # f32 [5, M]: fx, fy, fz, radius, atom index
    b_start: torch.Tensor   # i32 [C, 3]: blocker runs of each column
    b_count: torch.Tensor   # i32 [C, 3]
    nudge: torch.Tensor     # f32 [K, 3]: outward nudge, fractional
    missed: torch.Tensor    # bool []


def surface_layout(frac_atoms, inv_cell, radii, r_probe, dirs, grid,
                   nbx: int, nby: int, window: int, col_cap: int,
                   cand_mask=None) -> SurfaceLayout:
    """Centers sorted by coarse column with candidate atoms first (so the
    slots after a column's candidate prefix skip the blocker pass), and
    the y-duplicated blocker runs of every column."""
    n = frac_atoms.shape[0]
    dev = frac_atoms.device
    n_cols = nbx * nby
    fx = _wrap01(frac_atoms[:, 0])
    fy = _wrap01(frac_atoms[:, 1])
    fz = _wrap01(frac_atoms[:, 2])
    bx = torch.clamp((fx * nbx).to(_I32), max=nbx - 1)
    by = torch.clamp((fy * nby).to(_I32), max=nby - 1)
    gidx = torch.arange(n, dtype=_F32, device=dev)
    cand = surface_candidate_mask(frac_atoms, inv_cell, radii, r_probe,
                                  dirs, grid, cand_mask)
    # exact keys (column, candidate first, fz) in separate bit fields: the
    # bits of fz in [0, 1] (below 2^30) order it as a float. A float32 key
    # col + fz / 2 rounds up to the next part for fz within an ulp of 1,
    # and from the last column past c_bounds[C], outside every column.
    part = (bx * nby + by).to(torch.int64) * 2 + (~cand).to(torch.int64)
    key_c = (part << 30) + fz.contiguous().view(_I32).to(torch.int64)
    keys_c, order = torch.sort(key_c, stable=True)
    centers = torch.stack([fx, fy, fz, radii, gidx])[:, order].contiguous()
    cols = torch.arange(n_cols + 1, dtype=torch.int64, device=dev) << 31
    c_bounds = torch.searchsorted(keys_c, cols).to(_I32)
    cand_end = torch.searchsorted(keys_c, cols[:-1] + (1 << 30)).to(_I32)
    missed = torch.any((c_bounds[1:] - c_bounds[:-1]) > col_cap)

    keys_b, blockers = _sort_atoms_xycols(frac_atoms, [radii, gidx],
                                          nbx, nby)
    cstarts_b = torch.searchsorted(
        keys_b, torch.arange(nbx * (nby + 2) + 1, dtype=_F32, device=dev))
    b_st, b_cnt, b_missed = _runs(cstarts_b, n_cols, nbx, nby, window)
    nudge = matvec3(dirs * 0.2, inv_cell).contiguous()
    return SurfaceLayout(centers, c_bounds.contiguous(),
                         cand_end.contiguous(), blockers, b_st, b_cnt,
                         nudge, missed | b_missed)


# --------------------------------------------------------------------------
# Kernel #5's plain version: probe/channel voxel masks + MC point fits
# --------------------------------------------------------------------------

def _tile_centers(t, nbx: int, nby: int):
    ti, tj = t // nby, t % nby
    return (ti, tj, _div(ti.to(_F32) + 0.5, nbx), _div(tj.to(_F32) + 0.5, nby))


def _gather_runs(payload, start, count, window: int):
    """Rows of the three runs of each tile: (columns [b, 3W] of payload
    rows, ok bool[b, 3W] marking rows inside their run)."""
    w_idx = torch.arange(window, device=payload.device, dtype=_I32)
    rows = start[:, :, None] + w_idx
    ok = (w_idx < count[:, :, None]).reshape(start.shape[0], -1)
    rows = torch.clamp(rows, max=payload.shape[1] - 1).reshape(
        start.shape[0], -1).long()
    return [payload[i][rows] for i in range(payload.shape[0])], ok


def _square(x):
    return x * x


def void_masks_tiles_plain(lay: MaskLayout, cell, grid, nbx: int, nby: int,
                           window: int, thr_hi: float, thr_lo: float,
                           thr_fit: float, pts_tiled=None,
                           tile_batch: int = 4):
    """Plain version of kernel #5 on a prepared layout.

    For each xy tile and each of its voxels, ``d2 >= (R_j + thr)^2`` over
    every candidate row of the tile's three runs, with the factorized
    quadratic d2(u) = (QQ + a*u^2) + u*QZ2 on the z-minimum-imaged
    offset u; MC points test ``d2 >= (R_j + thr_fit)^2`` on the unwrapped
    candidate positions. Returns (hi bool[gx, gy, gz], lo, fit bool[T, P]
    or None)."""
    dev = lay.payload.device
    gx, gy, gz = grid
    tvx, tvy = gx // nbx, gy // nby
    n_tiles, n_sub = nbx * nby, tvx * tvy
    c = cell
    azz = c[2, 0] * c[2, 0] + c[2, 1] * c[2, 1] + c[2, 2] * c[2, 2]
    sub = torch.arange(n_sub, device=dev)
    lx, ly = (sub // tvy).to(_F32), (sub % tvy).to(_F32)
    vz = _div(torch.arange(gz, dtype=_F32, device=dev) + 0.5, gz)
    two = thr_hi != thr_lo
    hi_t = torch.empty((n_tiles, n_sub, gz), dtype=torch.bool, device=dev)
    lo_t = torch.empty_like(hi_t) if two else hi_t
    fit = None
    if pts_tiled is not None:
        fit = torch.empty(pts_tiled.shape[:2], dtype=torch.bool, device=dev)
    for t0 in range(0, n_tiles, tile_batch):
        t = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        ti, tj, cx, cy = _tile_centers(t, nbx, nby)
        (fx, fy, fz, r), ok = _gather_runs(lay.payload, lay.start[t],
                                           lay.count[t], window)
        fxc = fx - torch.round(fx - cx[:, None])
        fyc = fy - torch.round(fy - cy[:, None])
        neg = torch.full_like(r, -1.0)
        th_hi = torch.where(ok, _square(r + thr_hi), neg)
        sfx = _div((ti * tvx).to(_F32)[:, None] + lx + 0.5, gx)  # [b, S]
        sfy = _div((tj * tvy).to(_F32)[:, None] + ly + 0.5, gy)
        dfx = sfx[:, :, None] - fxc[:, None, :]  # [b, S, 3W]
        dfy = sfy[:, :, None] - fyc[:, None, :]
        qx = dfx * c[0, 0] + dfy * c[1, 0]
        qy = dfx * c[0, 1] + dfy * c[1, 1]
        qz = dfx * c[0, 2] + dfy * c[1, 2]
        qq = qx * qx + qy * qy + qz * qz
        qdz = (qx * c[2, 0] + qy * c[2, 1] + qz * c[2, 2]) * 2.0
        dz = vz[None, :, None] - fz[:, None, :]  # [b, gz, 3W]
        u = dz - torch.round(dz)
        uu = azz * (u * u)
        d2 = (qq[:, :, None, :] + uu[:, None, :, :]
              + u[:, None, :, :] * qdz[:, :, None, :])  # [b, S, gz, 3W]
        hi_t[t] = torch.all(d2 >= th_hi[:, None, None, :], dim=-1)
        if two:
            th_lo = torch.where(ok, _square(r + thr_lo), neg)
            lo_t[t] = torch.all(d2 >= th_lo[:, None, None, :], dim=-1)
        del d2
        if fit is not None:
            p = pts_tiled[t]  # [b, P, 3]
            v = matvec3(p, c)
            wcx = fxc * c[0, 0] + fyc * c[1, 0] + fz * c[2, 0]
            wcy = fxc * c[0, 1] + fyc * c[1, 1] + fz * c[2, 1]
            wcz = fxc * c[0, 2] + fyc * c[1, 2] + fz * c[2, 2]
            s = torch.round(p[:, :, 2, None] - fz[:, None, :])  # [b, P, 3W]
            dx = v[:, :, 0, None] - wcx[:, None, :] - s * c[2, 0]
            dy = v[:, :, 1, None] - wcy[:, None, :] - s * c[2, 1]
            dzp = v[:, :, 2, None] - wcz[:, None, :] - s * c[2, 2]
            d2p = dx * dx + dy * dy + dzp * dzp
            th_f = torch.where(ok, _square(r + thr_fit), neg)
            fit[t] = torch.all(d2p >= th_f[:, None, :], dim=-1)

    def to_grid(m):
        g = m.reshape(nbx, nby, tvx, tvy, gz)
        return g.permute(0, 2, 1, 3, 4).reshape(gx, gy, gz).contiguous()

    return to_grid(hi_t), to_grid(lo_t), fit


# z voxels per slab of kernel #5 (``ZG`` in csrc/void_masks.cu)
VOID_SLAB = 8
_SIGMA = 2.0 ** -20


def _z_cut_geometry(cell):
    """(h_z, mu) in float64 from the f32 cell, in kernel #5's expression
    order: the z lattice-plane spacing |c.(a x b)| / |a x b| and the reach
    margin 0.05 A + 1e-3 (|a| + |b| + |c|)."""
    c = [float(x) for x in cell.detach().cpu().reshape(-1)]
    n0 = c[1] * c[5] - c[2] * c[4]
    n1 = c[2] * c[3] - c[0] * c[5]
    n2 = c[0] * c[4] - c[1] * c[3]
    hz = abs(n0 * c[6] + n1 * c[7] + n2 * c[8]) / math.sqrt(
        n0 * n0 + n1 * n1 + n2 * n2)
    length = (math.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
              + math.sqrt(c[3] * c[3] + c[4] * c[4] + c[5] * c[5])
              + math.sqrt(c[6] * c[6] + c[7] * c[7] + c[8] * c[8]))
    return hz, 0.05 + 1e-3 * length


def void_masks_z_window(lay: MaskLayout, cell, grid, nbx: int, nby: int,
                        window: int, thr_hi: float):
    """Plain twin of kernel #5's z cut, for tests (never on the card's
    path): keep bool[T, n_slabs, 3 * window], the candidate rows (in
    ``_gather_runs`` order) that the kernel stages for each (tile, slab of
    ``VOID_SLAB`` z voxels). A row is kept iff it lies in its run, its key is
    in one of its column's subranges [fl(c + lo), fl(c + hi)] around the
    slab widened by the tile's largest reach, and its periodic fractional
    distance to the slab is below (R + thr_hi + mu) / h_z + 2^-20 (the
    exactness argument is in the kernel's header)."""
    gz, slab = grid[2], VOID_SLAB
    n_slabs = -(-gz // slab)
    hz, mu = _z_cut_geometry(cell)
    cut = hz > 0.0
    inv_hz = float(np.float32(1.0 / hz)) if cut else math.inf
    reach_add = float(np.float32(thr_hi + mu))
    kmax = np.float32(nbx * (nby + 2))
    ulp2 = 2.0 * float(np.spacing(kmax))
    (_, _, fz, r), ok = _gather_runs(lay.payload, lay.start, lay.count,
                                     window)
    w_idx = torch.arange(window, device=fz.device)
    rows = (lay.start[:, :, None] + w_idx).reshape(fz.shape[0], -1)
    rows = torch.clamp(rows, max=lay.payload.shape[1] - 1).long()
    col = (torch.searchsorted(lay.cstarts, rows, right=True) - 1).double()
    key = lay.keys[rows]
    rmax = torch.where(ok, r, torch.zeros_like(r)).amax(dim=1).double()
    keep = torch.zeros((fz.shape[0], n_slabs, fz.shape[1]),
                       dtype=torch.bool, device=fz.device)
    for s in range(n_slabs):
        z0 = s * slab
        za = float(np.float32(z0) / np.float32(gz))
        zb = float(np.float32(min(z0 + slab, gz)) / np.float32(gz))
        ranges = [(torch.zeros_like(rmax), torch.ones_like(rmax))]
        if cut:
            w = ((rmax + thr_hi) + mu) / hz + _SIGMA + ulp2
            lo_z, hi_z = za - w, zb + w
            part = (hi_z - lo_z) < 1.0
            zero, one = torch.zeros_like(w), torch.ones_like(w)
            ranges = [
                (torch.where(part, torch.clamp(lo_z, min=0.0), zero),
                 torch.where(part, torch.clamp(hi_z, max=1.0), one)),
                (torch.where(part & (lo_z < 0), lo_z + 1.0,
                             torch.where(part & (hi_z > 1), zero, one)),
                 torch.where(part & (lo_z < 0), one,
                             torch.where(part & (hi_z > 1), hi_z - 1.0,
                                         zero))),
            ]
        in_range = torch.zeros_like(ok)
        for lo, hi in ranges:
            k_lo = (col + lo[:, None]).float()
            k_hi = (col + hi[:, None]).float()
            in_range |= (lo <= hi)[:, None] & (key >= k_lo) & (key <= k_hi)
        d = torch.where(fz < za, za - fz,
                        torch.where(fz > zb, fz - zb, torch.zeros_like(fz)))
        d = torch.minimum(d, torch.minimum(fz + 1.0 - zb, za + 1.0 - fz))
        near = ~(d >= (r + reach_add) * inv_hz + _SIGMA)
        keep[:, s] = ok & in_range & near
    return keep


def mask_thresholds(probe: float, chan: float):
    """(thr_hi, thr_lo, thr_fit) as float32 values."""
    return (float(np.float32(max(probe, chan))),
            float(np.float32(min(probe, chan))),
            float(np.float32(probe)))


def void_masks_columns(frac_atoms, cell, radii, grid, probe: float,
                       chan: float, nbx: int, nby: int, window: int,
                       pts_tiled=None):
    """Probe-fit void masks via sorted xy-columns, plain PyTorch (kernel
    #5's plain version, any device).

    Returns (mask_probe bool[gx, gy, gz], mask_chan, fit_pts bool[T, P]
    or None, missed bool[]): the masks are ``d >= probe`` / ``d >= chan``
    for d the distance to the nearest atom surface, the point fits
    ``d >= probe`` at the MC points, and ``missed`` flags a candidate run
    longer than ``window`` (the frame must be recomputed wider)."""
    if grid[0] % nbx or grid[1] % nby:
        raise ValueError("xy columns must tile the grid")
    lay = masks_layout(frac_atoms, radii, nbx, nby, window)
    thr_hi, thr_lo, thr_fit = mask_thresholds(probe, chan)
    hi, lo, fit = void_masks_tiles_plain(
        lay, cell, grid, nbx, nby, window, thr_hi, thr_lo, thr_fit,
        pts_tiled)
    m_probe, m_chan = (hi, lo) if probe >= chan else (lo, hi)
    return m_probe, m_chan, fit, lay.missed


def grid_lookup(field, frac_pts, grid):
    """Nearest-voxel lookup of a grid field at fractional points."""
    gvec = _on_device(tuple(grid), _F32, frac_pts.device)
    gmax = _on_device(tuple(grid), _I32, frac_pts.device) - 1
    f = _wrap01(frac_pts)
    idx = torch.minimum((f * gvec).to(_I32), gmax).long()
    return field[idx[..., 0], idx[..., 1], idx[..., 2]]


# --------------------------------------------------------------------------
# Kernel #6's plain version: surface point validity
# --------------------------------------------------------------------------

def surface_candidate_mask(frac_atoms, inv_cell, radii, r_probe, dirs,
                           grid, cand_mask):
    """Exact per-atom candidate prefilter: an atom is a candidate iff any
    of its K sphere points lands on a voxel of ``cand_mask`` (or, within
    5e-4 voxel of a voxel boundary, on its periodic 3^3 dilation, which
    absorbs last-ulp index disagreement with the kernel's own point
    arithmetic). bool[N]; all true when ``cand_mask`` is None."""
    n = frac_atoms.shape[0]
    dev = frac_atoms.device
    if cand_mask is None:
        return torch.ones((n,), dtype=torch.bool, device=dev)
    gvec = _on_device(tuple(grid), _F32, dev)
    gmax = _on_device(tuple(grid), _I32, dev) - 1
    fbase = _wrap01(frac_atoms)
    k = dirs.shape[0]
    md = cand_mask
    for ax in range(3):  # separable periodic 3^3 dilation
        md = md | torch.roll(md, 1, ax) | torch.roll(md, -1, ax)
    code = cand_mask.to(torch.int8) | (md.to(torch.int8) << 1)
    cflat = code.reshape(-1)
    fo = matvec3(dirs, inv_cell)  # [K, 3] frac offset per unit dir
    nshift = matvec3(dirs * 0.2, inv_cell)
    fp_all = fbase[:, None, :] + (radii[:, None, None] + r_probe) * fo[None]

    def lin_bnd(f):
        f = _wrap01(f)
        fg = f * gvec
        idx = torch.minimum(fg.to(_I32), gmax)
        lin = (idx[..., 0] * grid[1] + idx[..., 1]) * grid[2] + idx[..., 2]
        near = torch.any(torch.abs(fg - torch.round(fg)) < 5e-4, dim=-1)
        return lin, near

    l1, nb1 = lin_bnd(fp_all)
    l2, nb2 = lin_bnd(fp_all + nshift[None])
    c1 = cflat[l1.reshape(-1).long()].reshape(n, k)
    c2 = cflat[l2.reshape(-1).long()].reshape(n, k)
    cand_pt = (((c1 & 1) | (c2 & 1)) != 0) | (nb1 & (c1 >= 2)) \
        | (nb2 & (c2 >= 2))
    return cand_pt.any(dim=1)


def _linear_idx(fx, fy, fz, grid):
    out = []
    for f, g in zip((fx, fy, fz), grid):
        f = _wrap01(f)
        out.append(torch.clamp((f * g).to(_I32), max=g - 1))
    return (out[0] * grid[1] + out[1]) * grid[2] + out[2]


def active_slots(lay: SurfaceLayout, n_z: int, chunk: int):
    """(slot column, first row, end row) of every slot that runs the
    blocker pass: a slot is ``chunk`` consecutive centers of one column
    (at most ``n_z`` per column) that holds a candidate atom."""
    cb = lay.c_bounds.cpu().numpy().astype(np.int64)
    ce = lay.cand_end.cpu().numpy().astype(np.int64)
    n_cols = len(ce)
    z = np.arange(n_z)
    lo = cb[:-1, None] + z[None, :] * chunk
    hi = np.minimum(lo + chunk, cb[1:, None])
    act = (lo < hi) & (lo < ce[:, None])
    col = np.broadcast_to(np.arange(n_cols)[:, None], lo.shape)
    return col[act], lo[act], hi[act]


# (center, direction) items one group of kernel #6 holds at most
SURFACE_ITEMS = 32


def surface_group_size(k: int) -> int:
    """Centers in one group of kernel #6 (a block takes one at a time) at ``k``
    directions: as many as fill ``SURFACE_ITEMS`` items, 1 to 32."""
    return max(1, min(32, SURFACE_ITEMS // k))


def surface_groups(lay: SurfaceLayout, n_z: int, chunk: int, group: int):
    """(column, first row, end row) of every group of kernel #6: each
    active slot's nc candidate rows in min(nc, P) runs of near-equal size
    (P = ceil(chunk / group), so few candidates spread over z go one or
    two a group), then its other rows in runs of ``group`` (each group is
    sorted in z)."""
    cols, los, his = active_slots(lay, n_z, chunk)
    ce = lay.cand_end.cpu().numpy().astype(np.int64)
    places = -(-chunk // group)
    out = []
    for col, lo, hi in zip(cols, los, his):
        nc = min(hi, ce[col]) - lo
        ncg = min(nc, places)
        out += [(col, lo + i * nc // ncg, lo + (i + 1) * nc // ncg)
                for i in range(ncg)]
        out += [(col, g0, min(g0 + group, hi))
                for g0 in range(lo + nc, hi, group)]
    arr = np.array(out, np.int64).reshape(-1, 3)
    return arr[:, 0], arr[:, 1], arr[:, 2]


def surface_z_window(lay: SurfaceLayout, cell, dirs, r_probe: float,
                     n_z: int, chunk: int, group: int, window: int):
    """Plain twin of kernel #6's z cut, for tests (never on the card's
    path): ((cols, g0s, g1s) of ``surface_groups``, keep bool[G, 3 *
    window]), the blocker rows (in ``_gather_runs`` order of the group's
    column) that the kernel stages for each group. With [a, b] the
    group's fractional z range, P the largest |R_i + probe| |dir_k| of its
    points and t_j = |R_j + probe - 1e-4|, a row of the column's runs is
    kept iff its periodic fractional distance to [a, b] is below (t_j + P
    + mu) / h_z + 2^-20 (h_z, mu as ``_z_cut_geometry``); a degenerate
    cell (h_z = 0) keeps every row. The exactness argument is in the
    kernel's header."""
    dev = lay.centers.device
    cols, g0s, g1s = surface_groups(lay, n_z, chunk, group)
    hz, mu = _z_cut_geometry(cell)
    col_t = torch.as_tensor(cols, device=dev)
    (_, _, fz, r, _), ok = _gather_runs(lay.blockers, lay.b_start[col_t],
                                        lay.b_count[col_t], window)
    if not hz > 0.0:
        return (cols, g0s, g1s), ok
    inv_hz = float(np.float32(1.0 / hz))
    rp = float(np.float32(r_probe))
    peps = float(np.float32(r_probe) - np.float32(1e-4))
    d64 = dirs.detach().cpu().double()
    dn = float(torch.sqrt((d64 * d64).sum(dim=1)).max())
    g_idx = torch.as_tensor(g0s, device=dev)[:, None] + torch.arange(
        group, device=dev)
    live = g_idx < torch.as_tensor(g1s, device=dev)[:, None]
    g_idx = torch.clamp(g_idx, max=lay.centers.shape[1] - 1)
    fzc = lay.centers[2][g_idx]
    inf = torch.full_like(fzc, math.inf)
    a = torch.where(live, fzc, inf).amin(dim=1)[:, None]
    b = torch.where(live, fzc, -inf).amax(dim=1)[:, None]
    rx = torch.abs(lay.centers[3][g_idx] + rp)
    reach_add = (torch.where(live, rx, torch.zeros_like(rx)).amax(
        dim=1).double() * dn + mu).float()[:, None]
    d = torch.where(fz < a, a - fz,
                    torch.where(fz > b, fz - b, torch.zeros_like(fz)))
    d = torch.minimum(d, torch.minimum(fz + 1.0 - b, a + 1.0 - fz))
    near = ~(d >= (torch.abs(r + peps) + reach_add) * inv_hz + _SIGMA)
    return (cols, g0s, g1s), ok & near


def surface_valid_tiles_plain(lay: SurfaceLayout, cell, inv_cell, dirs,
                              r_probe: float, grid, nbx: int, nby: int,
                              window: int, n_z: int, chunk: int,
                              slot_batch: int = 16):
    """Plain version of kernel #6 on a prepared layout: for the centers of
    every active slot and every direction k, the point p = c + (R + probe)
    * dir_k, its voxel and its outward nudge's voxel (linear indices), and
    ``valid``: d2 > (R_j + probe - 1e-4)^2 against every blocker of the
    column's three runs but the atom itself. Rows outside active slots
    keep valid False and indices 0."""
    dev = lay.centers.device
    n = lay.centers.shape[1]
    k = dirs.shape[0]
    c, ic = cell, inv_cell
    rp = float(np.float32(r_probe))
    peps = float(np.float32(r_probe) - np.float32(1e-4))
    valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
    i_pt = torch.zeros((n, k), dtype=_I32, device=dev)
    i_nu = torch.zeros((n, k), dtype=_I32, device=dev)
    cols, los, his = active_slots(lay, n_z, chunk)
    ch = torch.arange(chunk, device=dev)
    for s0 in range(0, len(cols), slot_batch):
        col = torch.as_tensor(cols[s0:s0 + slot_batch], device=dev)
        lo = torch.as_tensor(los[s0:s0 + slot_batch], device=dev)
        hi = torch.as_tensor(his[s0:s0 + slot_batch], device=dev)
        _, _, ucx, ucy = _tile_centers(col, nbx, nby)
        rows = lo[:, None] + ch  # [a, CH]
        live = rows < hi[:, None]
        rows = torch.clamp(rows, max=n - 1)
        fx, fy, fz, ra, cg = (lay.centers[i][rows] for i in range(5))
        fxu = fx - torch.round(fx - ucx[:, None])
        fyu = fy - torch.round(fy - ucy[:, None])
        ccx = fxu * c[0, 0] + fyu * c[1, 0] + fz * c[2, 0]
        ccy = fxu * c[0, 1] + fyu * c[1, 1] + fz * c[2, 1]
        ccz = fxu * c[0, 2] + fyu * c[1, 2] + fz * c[2, 2]
        rx = (ra + rp)[:, :, None]
        px = ccx[:, :, None] + rx * dirs[:, 0]  # [a, CH, K]
        py = ccy[:, :, None] + rx * dirs[:, 1]
        pz = ccz[:, :, None] + rx * dirs[:, 2]
        fpx = px * ic[0, 0] + py * ic[1, 0] + pz * ic[2, 0]
        fpy = px * ic[0, 1] + py * ic[1, 1] + pz * ic[2, 1]
        fpz = px * ic[0, 2] + py * ic[1, 2] + pz * ic[2, 2]
        lin = _linear_idx(fpx, fpy, fpz, grid)
        lin_n = _linear_idx(fpx + lay.nudge[:, 0], fpy + lay.nudge[:, 1],
                            fpz + lay.nudge[:, 2], grid)

        (bx, by, bz, br, bg), ok = _gather_runs(
            lay.blockers, lay.b_start[col], lay.b_count[col], window)
        wx = bx - torch.round(bx - ucx[:, None])
        wy = by - torch.round(by - ucy[:, None])
        wcx = wx * c[0, 0] + wy * c[1, 0] + bz * c[2, 0]  # [a, 3W]
        wcy = wx * c[0, 1] + wy * c[1, 1] + bz * c[2, 1]
        wcz = wx * c[0, 2] + wy * c[1, 2] + bz * c[2, 2]
        thr = torch.where(ok, _square(br + peps), torch.full_like(br, -1.0))
        e = (slice(None), None, None, slice(None))  # [a, 1, 1, 3W]
        zs = torch.round(fpz[..., None] - bz[e])  # [a, CH, K, 3W]
        dx = px[..., None] - wcx[e] - zs * c[2, 0]
        dy = py[..., None] - wcy[e] - zs * c[2, 1]
        dz = pz[..., None] - wcz[e] - zs * c[2, 2]
        d2 = dx * dx + dy * dy + dz * dz
        te = torch.where(bg[e] == cg[:, :, None, None],
                         torch.full_like(d2, -1.0), thr[e])
        ok_pt = torch.all(d2 > te, dim=-1) & live[:, :, None]
        sel = rows[live]
        valid[sel] = ok_pt[live]
        i_pt[sel] = lin[live]
        i_nu[sel] = lin_n[live]
    return valid, i_pt, i_nu


def surface_valid_columns(frac_atoms, cell, radii, r_probe, dirs, grid,
                          nbx: int, nby: int, window: int, chunk: int,
                          col_cap: int, cand_mask=None, inv_cell=None):
    """Per-point surface validity + voxel indices via coarse sorted xy
    columns, plain PyTorch (kernel #6's plain version, any device).

    Zeo++'s ASA construction: for each atom i, K points on the sphere of
    radius R_i + probe; a point counts iff it lies outside every OTHER
    atom's inflated sphere. ``cand_mask`` (the channel mask) enables the
    exact candidate prefilter: slots of ``chunk`` centers without a
    candidate atom skip the blocker pass.

    Returns (valid bool[N, K], idx_pt i32[N, K], idx_nudge i32[N, K],
    orig_idx i32[N], radii f32[N], missed bool[]), rows in the layout's
    center order (one row per atom)."""
    if inv_cell is None:
        inv_cell = host_inverse(cell)
    lay = surface_layout(frac_atoms, inv_cell, radii, r_probe, dirs, grid,
                         nbx, nby, window, col_cap, cand_mask)
    n_z = -(-col_cap // chunk)
    valid, i_pt, i_nu = surface_valid_tiles_plain(
        lay, cell, inv_cell, dirs, r_probe, grid, nbx, nby, window, n_z,
        chunk)
    return (valid, i_pt, i_nu, lay.centers[4].to(_I32), lay.centers[3],
            lay.missed)


def classify_surface_points(valid, idx_pt, idx_nudge, accessible, pocket):
    """(acc_counts i32[S], nacc_counts i32[S]): per-slot counts of valid
    points whose voxel (or outward nudge's voxel) is accessible, and of
    the remaining valid points that land in a pocket."""
    code = (accessible.to(torch.int8)
            + 2 * pocket.to(torch.int8)).reshape(-1)
    c1 = code[idx_pt.reshape(-1).long()].reshape(idx_pt.shape)
    c2 = code[idx_nudge.reshape(-1).long()].reshape(idx_nudge.shape)
    acc = (c1 == 1) | (c2 == 1)
    poc = (c1 == 2) | (c2 == 2)
    return (torch.sum(valid & acc, dim=1).to(_I32),
            torch.sum(valid & ~acc & poc, dim=1).to(_I32))


# --------------------------------------------------------------------------
# Connectivity: the flood-fill fixpoint (kernel #7) and its callers
# --------------------------------------------------------------------------

def _neighbor_max(labels, mask, periodic: bool):
    """One 6-neighbour max-propagation sweep over the masked region."""
    out = labels
    for axis in range(3):
        for shift in (1, -1):
            rolled = torch.roll(labels, shift, axis)
            if not periodic:
                # drop the contribution that wrapped around
                idx = 0 if shift == 1 else labels.shape[axis] - 1
                rolled.select(axis, idx).fill_(-1)
            out = torch.maximum(out, rolled)
    return torch.where(mask, out, torch.full_like(out, -1))


def propagate_fixpoint_plain(init, periodic: bool, sweeps: int = 8):
    """Plain version of kernel #7: masked 6-neighbour max sweeps (walls
    are init < 0, returned as -1) until nothing changes."""
    mask = init >= 0
    labels = torch.where(mask, init, torch.full_like(init, -1))
    while True:
        new = labels
        for _ in range(sweeps):
            new = _neighbor_max(new, mask, periodic)
        if torch.equal(new, labels):
            return labels
        labels = new


def _check_labels(init):
    if init.dtype != _I32 or init.dim() != 3:
        raise ValueError("init must be int32 [gx, gy, gz]")
    if not init.is_contiguous():
        raise ValueError("init must be contiguous")
    if init.numel() >= 2**31:
        raise ValueError("grid too large for int32 voxel indices")


# kernel #7's tile, (x, y, z) voxels, as in csrc/flood_fill.cu
FLOOD_TILE = (8, 8, 16)
# its launches, in order, as flood_fill_geometry reports them
FLOOD_STEPS = ("tiles", "faces", "gather")


def flood_tiles(shape) -> int:
    """Tiles kernel #7 cuts a grid of ``shape`` into (one block each)."""
    (gx, gy, gz), (tx, ty, tz) = shape, FLOOD_TILE
    return -(-gx // tx) * -(-gy // ty) * -(-gz // tz)


def propagate_fixpoint(init, periodic: bool):
    """Fixpoint of masked 6-neighbour max propagation: every voxel with
    init >= 0 ends with the maximum init over its connected component
    (6-connectivity; periodic or open boundaries), every other voxel with
    -1. Kernel #7 (``csrc/flood_fill.cu``) for CUDA tensors, the plain
    sweeps for CPU tensors.

    On the card the result and the kernel's scratch (union-find parents,
    one flag a tile) are one allocation, since the call is host-bound: the
    returned tensor is a view of its first ``init.numel()`` ints and keeps
    the rest (about as many again) alive while it lives."""
    _check_labels(init)
    if init.device.type == "cpu":
        return propagate_fixpoint_plain(init, periodic)
    from amof_tpu_torch import _build

    gx, gy, gz = init.shape
    n = init.numel()
    buf = torch.empty(2 * n + flood_tiles(init.shape), dtype=_I32,
                      device=init.device)
    ptr = buf.data_ptr()
    err = _build.library().flood_fill_launch(
        init.data_ptr(), gx, gy, gz, int(bool(periodic)), ptr + 4 * n, ptr,
        _build.stream_ptr(init))
    _build.check(err, "flood_fill")
    tracing.count("launch.flood_fill")  # CPU calls do not count
    return buf.as_strided((gx, gy, gz), (gy * gz, gz, 1))


def flood_fill_geometry(shape) -> dict:
    """What kernel #7's launches get at ``shape`` on the current card:
    {step: {blocks, threads, smem_bytes (static), registers,
    blocks_per_sm}} for each of ``FLOOD_STEPS``, plus ``tile`` and
    ``scratch_ints`` as the CUDA source computes them."""
    import ctypes

    from amof_tpu_torch import _build

    geo = (ctypes.c_int * (5 * len(FLOOD_STEPS) + 4))()
    _build.check(_build.library().flood_fill_geometry(*shape, geo),
                 "flood_fill_geometry")
    keys = ("blocks", "threads", "smem_bytes", "registers", "blocks_per_sm")
    out = {step: dict(zip(keys, geo[5 * k:5 * k + 5]))
           for k, step in enumerate(FLOOD_STEPS)}
    out["tile"] = tuple(geo[-4:-1])
    out["scratch_ints"] = geo[-1]
    return out


def label_components(mask, periodic: bool = True):
    """Connected-component labels of a 3-d boolean mask (6-connectivity):
    the largest voxel linear index of each component; -1 outside."""
    init = torch.where(
        mask,
        torch.arange(mask.numel(), dtype=_I32,
                     device=mask.device).reshape(mask.shape),
        torch.full(mask.shape, -1, dtype=_I32, device=mask.device))
    return propagate_fixpoint(init, periodic)


def winding_seeds(open_labels, mask):
    """Voxels on a periodic face where the open component meets itself
    across the wrap (label equal on opposite faces)."""
    seeds = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    for axis in range(3):
        a = open_labels.select(axis, -1)
        b = open_labels.select(axis, 0)
        wins = (a == b) & (a >= 0)
        last = seeds.select(axis, -1)
        last |= wins
        first = seeds.select(axis, 0)
        first |= wins
    return seeds & mask


def propagate_channel(channel_seed, mask):
    """Channel membership spread through periodic connectivity: every
    voxel periodically connected to a seed is accessible."""
    seed = torch.where(channel_seed, 1, torch.where(mask, 0, -1)).to(_I32)
    return propagate_fixpoint(seed, True) == 1


def void_classification_mask(mask, return_faces: bool = False):
    """(mask, accessible, pocket) from a probe-fit mask: open components
    that meet themselves across a periodic face are channels; channel
    status spreads through periodic connectivity; the rest of the mask is
    pocket. With ``return_faces`` also the wrap-edge label pairs of the
    open labels (``face_label_pairs``), from which the host winding
    analysis (``pore/winding.py``) certifies the face test."""
    open_labels = label_components(mask, periodic=False)
    seeds = winding_seeds(open_labels, mask)
    accessible = propagate_channel(seeds, mask)
    if return_faces:
        return (mask, accessible, mask & ~accessible,
                face_label_pairs(open_labels))
    return mask, accessible, mask & ~accessible


def void_classification(dist, r_probe, return_faces: bool = False):
    """(mask, accessible, pocket) voxel masks of a distance field for a
    probe radius."""
    return void_classification_mask(dist >= r_probe, return_faces)


def face_label_pairs(open_labels):
    """Wrap-edge label pairs of an open component labelling: i32[2,
    n_face], column j holding (label at the last slice, label at the
    first slice) of one periodic face position, the three axes in order.
    With ``face_axis_ids`` this is the whole quotient graph of the
    periodic void network: every edge between open components crosses a
    face."""
    a = [open_labels.select(axis, -1).reshape(-1) for axis in range(3)]
    b = [open_labels.select(axis, 0).reshape(-1) for axis in range(3)]
    return torch.stack([torch.cat(a), torch.cat(b)])


def face_axis_ids(grid) -> np.ndarray:
    """Axis id (0/1/2) of each ``face_label_pairs`` column."""
    gx, gy, gz = grid
    return np.repeat(np.arange(3), [gy * gz, gx * gz, gx * gy])


def percolating_flags(open_labels, mask):
    """Per-voxel flag: does this voxel's open component meet itself
    across a periodic face (an infinite channel)? A scatter-max of the
    face wins over the labels."""
    n = open_labels.numel()
    flag = torch.zeros(n + 1, dtype=torch.uint8, device=mask.device)
    for axis in range(3):
        a = open_labels.select(axis, -1).reshape(-1)
        b = open_labels.select(axis, 0).reshape(-1)
        wins = (a == b) & (a >= 0)
        idx = torch.where(wins, a, torch.full_like(a, n)).long()
        flag.scatter_reduce_(0, idx, wins.to(torch.uint8), "amax")
    lab = open_labels.reshape(-1).long()
    lab = torch.where(lab >= 0, lab, lab + (n + 1))  # -1 reads slot n
    return flag[lab].reshape(open_labels.shape).bool() & mask


def dilate(mask, steps: int):
    """Periodic 6-neighbour dilation (octahedral structuring element),
    ``steps`` times."""
    out = mask
    for _ in range(steps):
        grown = out
        for axis in range(3):
            for shift in (1, -1):
                grown = grown | torch.roll(out, shift, axis)
        out = grown
    return out


# --------------------------------------------------------------------------
# Distance fields: the per-frame path and BatchedPore's non-column plans
# --------------------------------------------------------------------------
#
# d(v) = min_i (|v - r_i|_mic - R_i), pair by pair in the reference's
# expression order: df - floor(df + 0.5), matvec3, sqrt, then - R. A block
# of voxels (x planes, or tiles, times every z) and its candidate atoms
# share the wrapped fractional offsets of each axis ([B, n_axis, W]), so
# each Cartesian component is formed as matvec3 forms it, (x term + y
# term) + z term, without a [B, C, W, 3] offset tensor; on a diagonal
# cell a component depends on one axis only and the squared norm is
# (x^2 + y^2) + z^2 of per-axis tables. The minimum over atoms is exact
# in any grouping, so blocks are sized by memory: FIELD_BYTES for each
# f32 temporary.

FIELD_BYTES = 256 << 20


def _sqrt(x):
    """Correctly rounded float32 sqrt, in place where it can be: CUDA's
    sqrtf is IEEE; the CPU takes ``sqrt_rn``."""
    return x.sqrt_() if x.is_cuda else sqrt_rn(x)


def _axis_centres(g: int, dev):
    return _div(torch.arange(g, dtype=_F32, device=dev) + 0.5, g)


def _wrapped(v, a):
    """v[..., n, None] - a[..., None, W], wrapped: df - floor(df + 0.5)."""
    df = v[..., :, None] - a[..., None, :]
    return df - torch.floor(df + 0.5)


def _is_diagonal(cell) -> bool:
    c = cell.detach().cpu()
    return bool(torch.count_nonzero(c - torch.diag(torch.diagonal(c))) == 0)


def _block_min(wx, wy, wz, r, cell, diag: bool):
    """f32 [B, nx, ny, nz]: min over W of sqrt(|matvec3(w, cell)|^2) - r
    for wrapped offsets wx [B, nx, W], wy [B, ny, W], wz [B, nz, W] and
    radii r [B, W] (-inf drops a candidate)."""
    if diag:
        x2, y2, z2 = (_square(w * cell[k, k])
                      for k, w in enumerate((wx, wy, wz)))
        xy = x2[:, :, None, :] + y2[:, None, :, :]
        s = xy[:, :, :, None, :] + z2[:, None, None, :, :]
    else:
        s = None
        for k in range(3):
            xy = (wx * cell[0, k])[:, :, None, :] \
                + (wy * cell[1, k])[:, None, :, :]
            c = xy[:, :, :, None, :] + (wz * cell[2, k])[:, None, None, :, :]
            c.mul_(c)
            s = c if s is None else s.add_(c)
    s = _sqrt(s)
    s.sub_(r[:, None, None, None, :])
    return s.amin(dim=-1)


def _rows_per_block(row_bytes: int, n_rows: int) -> int:
    return max(1, min(n_rows, FIELD_BYTES // max(row_bytes, 1)))


def distance_grid(frac_atoms, cell, radii, grid):
    """Distance-to-nearest-atom-surface field on the fractional voxel grid
    (voxel centres (i + 0.5) / G), f32 [Gx, Gy, Gz] in A, over every atom
    (rows with radius -inf are skipped)."""
    dev = frac_atoms.device
    gx, gy, gz = grid
    n = frac_atoms.shape[0]
    diag = _is_diagonal(cell)
    w = [_wrapped(_axis_centres(g, dev), frac_atoms[:, k])
         for k, g in enumerate(grid)]  # [G_k, N] each
    out = torch.empty(grid, dtype=_F32, device=dev)
    by = _rows_per_block(gz * n * 4, gy)
    bx = _rows_per_block(gy * gz * n * 4, gx) if by == gy else 1
    for x0 in range(0, gx, bx):
        for y0 in range(0, gy, by):
            out[x0:x0 + bx, y0:y0 + by] = _block_min(
                w[0][None, x0:x0 + bx], w[1][None, y0:y0 + by], w[2][None],
                radii[None], cell, diag)[0]
    return out


def _sort_by_x(frac_atoms):
    """(wrapped fractional x sorted, permutation): a stable sort on
    x - floor(x)."""
    return torch.sort(_wrap01(frac_atoms[:, 0]), stable=True)


def _circular_counts(xs, lo, hi):
    """(start, count) in sorted order of the atoms whose wrapped x lies in
    [lo, hi) taken modulo 1 (an interval may wrap the cell). ``lo`` and
    ``hi`` (numpy arrays or tensors) are reduced modulo 1 in their own
    precision, then cast to that of ``xs``."""
    n = xs.shape[0]
    lo, hi = (torch.remainder(torch.as_tensor(v, device=xs.device), 1.0)
              for v in (lo, hi))
    s = torch.searchsorted(xs, lo.to(xs.dtype))
    e = torch.searchsorted(xs, hi.to(xs.dtype))
    return s, torch.where(hi >= lo, e - s, e + (n - s))


def distance_grid_windowed(frac_atoms, cell, radii, grid, dmax: float,
                           dxa: float, chunk: int = 1024,
                           window: int = 1536):
    """Clamped distance field, exact wherever the true value is below
    ``dmax``, and the exact miss flag of ``amof_tpu``'s sorted window:
    (f32 [Gx, Gy, Gz], missed bool tensor).

    Atoms are sorted by wrapped fractional x. The flag is the
    reference's: x-major voxel chunks of ``chunk`` linear indices, each
    with the fractional-x reach [x_lo - dxa, x_hi + dxa] of its planes,
    count their atoms by binary search; a chunk with more than ``window``
    misses. The field takes each x plane with the atoms in its own reach
    (a subset of every such chunk's in-reach atoms, and a superset of the
    atoms within dmax + R of the plane), so where nothing misses it equals
    the reference's clamped minimum."""
    gx, gy, gz = grid
    n = frac_atoms.shape[0]
    if window >= n:
        raise ValueError("window must be smaller than the atom count")
    dev = frac_atoms.device
    n_vox = gx * gy * gz
    n_chunks = -(-n_vox // chunk)
    c0 = np.arange(n_chunks) * chunk
    lo = (c0 // (gy * gz) + 0.5) / gx - dxa
    hi = ((c0 + chunk - 1) // (gy * gz) + 0.5) / gx + dxa
    if float((hi - lo).max()) >= 1.0:
        # the reach covers the whole cell: no window exists
        return (torch.clamp(distance_grid(frac_atoms, cell, radii, grid),
                            max=dmax),
                torch.zeros((), dtype=torch.bool, device=dev))
    xs, order = _sort_by_x(frac_atoms)
    _, cnt = _circular_counts(xs, lo, hi)
    missed = torch.any(cnt > window)

    plane = np.arange(gx)
    start, count = _circular_counts(xs, (plane + 0.5) / gx - dxa,
                                    (plane + 0.5) / gx + dxa)
    w = int(count.max())
    if w == 0:
        return torch.full(grid, dmax, dtype=_F32, device=dev), missed
    fa = frac_atoms[order]
    rs = radii[order]
    j = torch.arange(w, device=dev)
    rows = (start[:, None] + j) % n  # [gx, w]
    r_pl = torch.where(j < count[:, None], rs[rows],
                       torch.full_like(rs[rows], -math.inf))
    diag = _is_diagonal(cell)
    vx, vy, vz = (_axis_centres(g, dev) for g in grid)
    out = torch.empty(grid, dtype=_F32, device=dev)
    by = _rows_per_block(gz * w * 4, gy)
    bx = _rows_per_block(gy * gz * w * 4, gx) if by == gy else 1
    for x0 in range(0, gx, bx):
        x1 = min(x0 + bx, gx)
        rr = rows[x0:x1]
        wx = _wrapped(vx[x0:x1, None], fa[rr, 0])  # [P, 1, w]
        wz = _wrapped(vz, fa[rr, 2])
        for y0 in range(0, gy, by):
            wy = _wrapped(vy[y0:y0 + by], fa[rr, 1])
            out[x0:x1, y0:y0 + by] = _block_min(
                wx, wy, wz, r_pl[x0:x1], cell, diag)[:, 0]
    return torch.clamp(out, max=dmax), missed


def _wrap_offset(df):
    return df - torch.floor(df + 0.5)


def _norm2(d, cell, diag: bool):
    """|matvec3(d, cell)|^2 in the reference's order for the wrapped
    fractional offsets d = (dx, dy, dz), each of one broadcast shape; on
    a diagonal cell each Cartesian component is d_k * cell[k, k] (the
    zero terms of matvec3 change no bit of its square)."""
    if diag:
        return (_square(d[0] * cell[0, 0]) + _square(d[1] * cell[1, 1])) \
            + _square(d[2] * cell[2, 2])
    s = None
    for j in range(3):
        c = (d[0] * cell[0, j] + d[1] * cell[1, j]) + d[2] * cell[2, j]
        c.mul_(c)
        s = c if s is None else s.add_(c)
    return s


def _pair_min(p, w, wr, cell, diag: bool):
    """f32 [..., P]: min over W of sqrt(|matvec3(wrap(p - w), cell)|^2)
    - wr, for points p [..., P, 3] and candidates w [..., W, 3], wr
    [..., W]."""
    d = [_wrap_offset(p[..., :, None, k] - w[..., None, :, k])
         for k in range(3)]
    return (_sqrt(_norm2(d, cell, diag)) - wr[..., None, :]).amin(dim=-1)


def point_distance_windowed(frac_atoms, cell, radii, pts, pts_x_lo,
                            pts_x_hi, dmax: float, dxa: float,
                            chunk: int = 1024, window: int = 1536):
    """Clamped min distance-to-atom-surface at sample points (the MC
    counterpart of ``distance_grid_windowed``): points sorted by
    fractional x in chunks of ``chunk``, each tested against the
    ``window`` atoms of sorted order that start at its reach
    [x_lo - dxa, x_hi + dxa]; a chunk whose reach holds more atoms (or
    spans the cell) misses. (f32 [M], missed bool tensor)."""
    n = frac_atoms.shape[0]
    m = pts.shape[0]
    if m % chunk:
        raise ValueError("sample count must divide into chunks")
    dev = frac_atoms.device
    n_chunks = m // chunk
    p = pts.reshape(n_chunks, chunk, 3)
    diag = _is_diagonal(cell)
    if window >= n:  # no window exists: every atom for every chunk
        return (torch.clamp(torch.cat([
            _pair_min(p[q], frac_atoms, radii, cell, diag)
            for q in range(n_chunks)]), max=dmax),
            torch.zeros((), dtype=torch.bool, device=dev))
    xs, order = _sort_by_x(frac_atoms)
    fa, rs = frac_atoms[order], radii[order]
    lo, hi = pts_x_lo - dxa, pts_x_hi + dxa
    s, cnt = _circular_counts(xs, lo, hi)
    missed = torch.any((cnt > window) | (hi - lo >= 1.0))
    rows = (s[:, None] + torch.arange(window, device=dev)) % n  # [Q, W]
    per = _rows_per_block(chunk * window * 4 * 3, n_chunks)
    out = torch.cat([
        _pair_min(p[q0:q0 + per], fa[rows[q0:q0 + per]],
                  rs[rows[q0:q0 + per]], cell, diag)
        for q0 in range(0, n_chunks, per)])
    return torch.clamp(out.reshape(-1), max=dmax), missed


def _sort_atoms_slab_y(frac_atoms, radii, nbx: int, y_img: float):
    """Atoms plus their y-wrap images sorted by an (x slab, y) key
    ``slab * 2 + fy``: each slab's run is y-ordered, and an atom with
    fy < ``y_img`` also appears at fy + 1 (key + 1), so every y window is
    one contiguous range even where it wraps. Images not needed carry key
    1e9 and sort to the tail. (keys, x, y, z, r), each f32 [2N] in sorted
    order (stable sort)."""
    fx, fy, fz = (_wrap01(frac_atoms[:, k]) for k in range(3))
    slab = torch.clamp((fx * nbx).to(_I32), max=nbx - 1).to(_F32)
    key0 = slab * 2.0 + fy
    key1 = torch.where(fy < y_img, key0 + 1.0,
                       torch.full_like(key0, 1e9))
    keys, order = torch.sort(torch.cat([key0, key1]), stable=True)
    cols = [torch.cat([fx, fx]), torch.cat([fy, fy + 1.0]),
            torch.cat([fz, fz]), torch.cat([radii, radii])]
    return (keys, *(c[order] for c in cols))


def distance_grid_windowed2(frac_atoms, cell, radii, grid, dmax: float,
                            dxa: float, dya: float, tvx: int = 4,
                            tvy: int = 16, nbx: int = 8, k_slabs: int = 3,
                            window: int = 512):
    """Clamped distance field through two-level sorted windows: each
    (tvx, tvy, Gz) voxel tile tests the atoms of ``k_slabs`` x slabs,
    each a ``window``-wide y-ordered run from the start of the tile's y
    reach, as ``amof_tpu`` slices them (a run past the end of the sorted
    array starts ``window`` rows before its end); rows with the image
    key 1e9 are skipped. A (tile, slab) whose reach holds more rows than
    ``window`` misses. (f32 [Gx, Gy, Gz] clamped at dmax, missed bool
    tensor)."""
    gx, gy, gz = grid
    if gx % tvx or gy % tvy:
        raise ValueError("tiles must divide the grid")
    dev = frac_atoms.device
    n_i, n_j = gx // tvx, gy // tvy
    ry = (tvy - 1) / gy + 2 * dya
    rx = (tvx - 1) / gx + 2 * dxa
    if ry >= 1.0:
        raise ValueError("y reach covers the cell; use the 1-level field")
    if k_slabs < int(np.ceil(rx * nbx)) + 1:
        raise ValueError(f"k_slabs={k_slabs} cannot cover x reach {rx} "
                         f"with nbx={nbx}")
    keys, xs, ys, zs, rs = _sort_atoms_slab_y(frac_atoms, radii, nbx, ry)
    n2 = keys.shape[0]
    x_lo = (np.arange(n_i) * tvx + 0.5) / gx - dxa
    slab0 = np.floor((x_lo % 1.0) * nbx).astype(np.int64)
    slabs = (slab0[:, None] + np.arange(k_slabs)[None, :]) % nbx
    y_lo = ((np.arange(n_j) * tvy + 0.5) / gy - dya) % 1.0
    q_lo = (slabs[:, None, :] * 2.0 + y_lo[None, :, None]).astype(
        np.float32)  # [n_i, n_j, K]
    q_hi = (q_lo + ry).astype(np.float32)
    starts = torch.searchsorted(keys, torch.from_numpy(
        q_lo.reshape(-1)).to(dev))
    ends = torch.searchsorted(keys, torch.from_numpy(
        q_hi.reshape(-1)).to(dev))
    missed = torch.any((ends - starts) > window)
    starts = torch.clamp(starts, max=n2 - window)
    rows = (starts[:, None] + torch.arange(window, device=dev)).reshape(
        n_i * n_j, k_slabs * window)
    r_t = torch.where(keys[rows] < 5e8, rs[rows],
                      torch.full_like(rs[rows], -math.inf))
    diag = _is_diagonal(cell)
    vx, vy, vz = (_axis_centres(g, dev) for g in grid)
    out = torch.empty((n_i, n_j, tvx, tvy, gz), dtype=_F32, device=dev)
    w = k_slabs * window
    per = _rows_per_block(tvx * tvy * gz * w * 4, n_i * n_j)
    for t0 in range(0, n_i * n_j, per):
        t = torch.arange(t0, min(t0 + per, n_i * n_j), device=dev)
        ti, tj = t // n_j, t % n_j
        rr = rows[t]
        wx = _wrapped(vx[ti[:, None] * tvx + torch.arange(tvx, device=dev)],
                      xs[rr])
        wy = _wrapped(vy[tj[:, None] * tvy + torch.arange(tvy, device=dev)],
                      ys[rr])
        wz = _wrapped(vz, zs[rr])
        out.view(n_i * n_j, tvx, tvy, gz)[t0:t0 + len(t)] = _block_min(
            wx, wy, wz, r_t[t], cell, diag)
    out = torch.clamp(out, max=dmax)
    return out.permute(0, 2, 1, 3, 4).reshape(gx, gy, gz), missed


# --------------------------------------------------------------------------
# Per-atom surface sampling (the per-frame path and the non-column plans)
# --------------------------------------------------------------------------

def _surface_counts(fa, ra, cand, cand_r, self_col, cell, inv_cell, r_probe,
                    dirs, accessible, pocket, grid):
    """(acc i32 [..., C], nacc) for centres fa [..., C, 3] (radii ra)
    against candidate blockers cand [..., W, 3] (radii cand_r), the
    column ``self_col`` [..., C] of each centre skipped: a sample point
    on the R + r_probe sphere is valid where every other candidate's
    R + r_probe sphere leaves it out (d > -1e-4), and is classified by
    the voxel of the point or of a 0.2 A outward nudge."""
    centres = matvec3(fa, cell)
    pts = centres[..., None, :] + (ra[..., None, None] + r_probe) * dirs
    fp = matvec3(pts, inv_cell)  # [..., C, K, 3]
    off = [_wrap_offset(fp[..., :, :, None, k]
                        - cand[..., None, None, :, k]) for k in range(3)]
    d = _sqrt(_norm2(off, cell, _is_diagonal(cell)))
    d = d - (cand_r[..., None, None, :] + r_probe)  # [..., C, K, W]
    col = torch.arange(cand.shape[-2], device=fa.device)
    skip = (col == self_col[..., None])[..., :, None, :] \
        | (cand_r < -1e8)[..., None, None, :]
    d = torch.where(skip, torch.full_like(d, math.inf), d)
    valid = (d.amin(dim=-1) > -1e-4) & (ra[..., None] > -1e8)
    nudge = fp + matvec3(dirs * 0.2, inv_cell)
    acc = grid_lookup(accessible, fp, grid) | grid_lookup(accessible, nudge,
                                                          grid)
    poc = grid_lookup(pocket, fp, grid) | grid_lookup(pocket, nudge, grid)
    return (torch.sum(valid & acc, dim=-1).to(_I32),
            torch.sum(valid & ~acc & poc, dim=-1).to(_I32))


def surface_point_classification(frac_atoms, cell, radii, r_probe, dirs,
                                 accessible, pocket, grid):
    """Per-atom accessible / non-accessible surface-point counts (i32 [N]
    each): K points on each atom's R + r_probe sphere, valid where no
    other atom's R + r_probe sphere holds them (Zeo++'s ASA construction,
    sampled on Fibonacci directions), classified by the void voxel they
    or their 0.2 A outward nudge fall in. Every atom is a blocker
    candidate; rows with radius < -1e8 are padding."""
    n = frac_atoms.shape[0]
    k = dirs.shape[0]
    inv_cell = host_inverse(cell)
    per = _rows_per_block(k * n * 4 * 3, n)
    cols = torch.arange(n, device=frac_atoms.device)
    acc, nacc = zip(*(
        _surface_counts(frac_atoms[i0:i0 + per], radii[i0:i0 + per],
                        frac_atoms, radii, cols[i0:i0 + per], cell,
                        inv_cell, r_probe, dirs, accessible, pocket, grid)
        for i0 in range(0, n, per)))
    return torch.cat(acc), torch.cat(nacc)


def _x_width(cell) -> torch.Tensor:
    """float32 |det(cell)| / |b x c|, computed on the CPU."""
    c = cell.detach().to("cpu", _F32)
    return (torch.abs(torch.linalg.det(c))
            / torch.linalg.norm(torch.linalg.cross(c[1], c[2])))


def surface_point_classification_windowed(frac_atoms, cell, radii, r_probe,
                                          dirs, accessible, pocket, grid,
                                          window: int = 1536,
                                          chunk: int = 32):
    """Sorted-window variant of ``surface_point_classification``: atoms
    are sorted by wrapped fractional x (stable), and each chunk of
    ``chunk`` sorted centres tests the ``chunk + 2 * window`` candidates
    around it (circularly), the self column of row i being ``window +
    i``. As in ``amof_tpu``, a last, partial chunk's candidates start
    ``chunk + 2 * window`` rows before the end of the extended order. A
    binary search per centre checks that every atom within the
    worst-case fractional-x reach lies within ``window`` sorted places.

    Returns (acc i32 [N'], nacc i32 [N'], orig_idx i32 [N'] (-1 on the
    padding rows), sorted radii f32 [N], missed): counts in sorted order,
    N' = N rounded up to ``chunk``."""
    n = frac_atoms.shape[0]
    dev = frac_atoms.device
    width = chunk + 2 * window
    if width >= n:
        raise ValueError("window too wide; use the full variant")
    inv_cell = host_inverse(cell)
    keys, order = _sort_by_x(frac_atoms)
    fa, rs = frac_atoms[order], radii[order]
    gis = order.to(_I32)

    rxa = _div((rs + radii.max()) + 2.0 * r_probe,
               float(_x_width(cell))) + 1e-6
    p = torch.arange(n, device=dev)
    x_hi, x_lo = keys + rxa, keys - rxa
    span_r = torch.where(
        x_hi < 1.0, torch.searchsorted(keys, x_hi) - 1 - p,
        (n - p) + torch.searchsorted(keys, x_hi - 1.0) - 1)
    span_l = torch.where(
        x_lo >= 0.0, p - torch.searchsorted(keys, x_lo),
        p + (n - torch.searchsorted(keys, x_lo + 1.0)))
    missed = torch.any((span_r > window) | (span_l > window))

    pad = (-n) % chunk
    fa_p = torch.cat([fa, torch.zeros((pad, 3), dtype=_F32, device=dev)])
    rs_p = torch.cat([rs, torch.full((pad,), -1e9, dtype=_F32, device=dev)])
    gis_p = torch.cat([gis, torch.full((pad,), -1, dtype=_I32, device=dev)])
    n_chunks = (n + pad) // chunk
    c0 = torch.arange(n_chunks, device=dev) * chunk
    first = torch.clamp(c0, max=n - chunk) - window  # extended -> sorted
    rows = (first[:, None] + torch.arange(width, device=dev)) % n
    self_col = window + torch.arange(chunk, device=dev)
    k = dirs.shape[0]
    per = _rows_per_block(chunk * k * width * 4 * 3, n_chunks)
    acc, nacc = [], []
    for q0 in range(0, n_chunks, per):
        q1 = min(q0 + per, n_chunks)
        a, b = _surface_counts(
            fa_p[q0 * chunk:q1 * chunk].reshape(q1 - q0, chunk, 3),
            rs_p[q0 * chunk:q1 * chunk].reshape(q1 - q0, chunk),
            fa[rows[q0:q1]], rs[rows[q0:q1]], self_col.expand(q1 - q0, -1),
            cell, inv_cell, r_probe, dirs, accessible, pocket, grid)
        acc.append(a.reshape(-1))
        nacc.append(b.reshape(-1))
    return torch.cat(acc), torch.cat(nacc), gis_p, rs, missed


# --------------------------------------------------------------------------
# -psd (covering spheres by FFT) and -ray_atom (sphere marching)
# --------------------------------------------------------------------------

def _voxel_offset_norms(cell, grid):
    """|Cartesian displacement| of every voxel-index offset, wrapped so
    offset 0 sits at index (0, 0, 0) (the circular-convolution layout)."""
    dev = cell.device
    offs = []
    for g in grid:
        i = torch.arange(g, device=dev)
        offs.append(_div(((i + g // 2) % g - g // 2).to(_F32), g))
    off = torch.stack(torch.meshgrid(*offs, indexing="ij"), dim=-1)
    return _sqrt(squared_norm(matvec3(off, cell)))


def covering_volume_counts(dist, centers_ok, target, cell, levels, grid):
    """Covering-sphere (Gelb-Gubbins) pore-volume counts, i64 [L]: for
    each radius t of ``levels`` the ``target`` voxels inside some sphere
    of radius t centred on a voxel u with dist[u] >= t and
    ``centers_ok[u]``. The periodic spherical dilation is an FFT circular
    convolution (``torch.fft`` in float32) of the zero-mean centre mask
    with the ball, its mean added back in closed form; the convolution is
    integer-valued, so the ``> 0.5`` threshold is exact while the FFT
    error stays below 0.5."""
    off_norm = _voxel_offset_norms(cell, grid)
    n_vox = grid[0] * grid[1] * grid[2]
    out = []
    for t in torch.as_tensor(levels, dtype=_F32).tolist():
        mask = ((dist >= t) & centers_ok).to(_F32)
        kern = (off_norm <= t).to(_F32)
        m_sum = torch.sum(mask)
        k_sum = torch.sum(kern)
        m_mean = _div(m_sum, n_vox)
        conv = torch.fft.irfftn(
            torch.fft.rfftn(mask - m_mean) * torch.fft.rfftn(kern), s=grid
        ) + m_mean * k_sum
        out.append(torch.sum((conv > 0.5) & target))
    return torch.stack(out)


def ray_chord_lengths(dist, frac_points, dirs, cell, r_probe, grid,
                      n_steps: int = 96, max_len: float = 50.0):
    """Chord lengths (f32 [M]) of rays through the probe-fit void (Zeo++
    -ray_atom): from each fractional start point, march along +dir and
    -dir on the distance field, each step the clearance (field minus
    r_probe) less half a voxel diagonal, at least a quarter of that
    slack, ``n_steps`` steps a direction, until the clearance drops below
    the slack; each direction capped at ``max_len`` A."""
    inv_cell = host_inverse(cell)
    dev = dist.device
    inv_g = 1.0 / torch.tensor(grid, dtype=_F32, device=dev)
    slack = 0.5 * _sqrt(torch.sum(_square(matvec3(inv_g[None], cell))))
    start = matvec3(frac_points, cell)

    def march(sign):
        s = torch.zeros(frac_points.shape[0], dtype=_F32, device=dev)
        alive = torch.ones(frac_points.shape[0], dtype=torch.bool,
                           device=dev)
        for _ in range(n_steps):
            p = start + (sign * s)[:, None] * dirs
            clearance = grid_lookup(dist, matvec3(p, inv_cell), grid) \
                - r_probe
            step = torch.clamp(clearance - slack, min=0.0)
            alive = alive & (clearance > slack) & (s < max_len)
            s = s + torch.where(alive, torch.maximum(step, 0.25 * slack),
                                torch.zeros_like(s))
            s = torch.clamp(s, max=max_len)
        return s

    return march(1.0) + march(-1.0)
