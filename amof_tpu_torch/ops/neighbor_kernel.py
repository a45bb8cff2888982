"""
K-slot neighbour tables over candidate windows, as hand-written CUDA
kernels with their plain PyTorch versions.

Counterpart of ``amof_tpu/ops/pallas_neighbors.py``:

  * ``window_table_slab`` replaces ``pallas_window_table_slab``
    (kernel #3): 2-level (x-slab, y) windows from
    ``slab_table.build_slab_layout``; slots in run-major column order;
  * ``window_table`` replaces ``pallas_window_table`` (kernel #4): the
    1-level circular window of ``chunk + 2*window`` atoms sorted by
    fractional x; slots in ascending window column.

Both launch ``csrc/window_table.cu`` (one warp per center, ballot-ordered
slots; see its header) for CUDA tensors and run the plain version for CPU
tensors. Outputs are three separate tensors (nbr_pos f32[M, K, 3],
nbr_sp i32[M, K], cnt i32[M]); empty slots hold position 0 and species
-1; ``cnt`` counts every valid candidate, so ``cnt > K`` flags overflow.

The JAX wrappers' TPU gates do not exist here: no 128-lane payload limit
(``1 + 4K <= 128``), no VMEM budget, no 128-alignment of chunk or window.
Any K the retry ladder asks for (up to 1024) runs on the card.
"""

from __future__ import annotations

import torch

from amof_tpu_torch.ops.pair_engine import (
    first_k_slots,
    inverse_cell,
    min_image_delta,
    squared_norm,
)

# launches of each wrapper's CUDA kernel (CPU calls do not count)
LAUNCHES = {"window_table_slab": 0, "window_table": 0}

_PLAIN_CELLS = 1 << 24  # candidate tests per plain-version batch


def _empty_table(m, k_cap, device):
    return (torch.zeros((m, k_cap, 3), dtype=torch.float32, device=device),
            torch.full((m, k_cap), -1, dtype=torch.int32, device=device),
            torch.zeros(m, dtype=torch.int32, device=device))


def _fill(table, row0, valid, cx, cy, cz, csp, k_cap):
    """Write the first K valid candidates of each row of ``valid``
    [R, C] (rows are table rows row0 + r) into ``table``."""
    nbr_pos, nbr_sp, cnt = table
    rows, cols, slots, c = first_k_slots(valid, k_cap)
    r = row0 + rows
    nbr_pos[r, slots, 0] = cx[rows, cols]
    nbr_pos[r, slots, 1] = cy[rows, cols]
    nbr_pos[r, slots, 2] = cz[rows, cols]
    nbr_sp[r, slots] = csp[rows, cols].to(torch.int32)
    cnt[row0:row0 + valid.shape[0]] = c.to(torch.int32)


# --------------------------------------------------------------------------
# Kernel #4: 1-level circular window over fractional-x-sorted atoms
# --------------------------------------------------------------------------

def window_table_plain(pos_sorted, sp_sorted, cell, cutoff_matrix,
                       max_neighbors: int, chunk: int, window: int,
                       inv_cell=None):
    """Plain PyTorch version of ``window_table``."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = pos_sorted.shape[0]
    dev = pos_sorted.device
    width = chunk + 2 * window
    cut2 = cutoff_matrix * cutoff_matrix
    sp = sp_sorted.long()
    table = _empty_table(n, max_neighbors, dev)
    cols = torch.arange(width, device=dev)
    per = max(1, _PLAIN_CELLS // (chunk * width))
    for c0 in range(0, n, chunk * per):
        c1 = min(c0 + chunk * per, n)
        i = torch.arange(c0, c1, device=dev)
        ci0 = (i // chunk) * chunk  # each center's window start
        j = (ci0[:, None] + cols[None, :] - window) % n  # [R, width]
        cand = pos_sorted[j]
        d2 = squared_norm(min_image_delta(
            cand - pos_sorted[i][:, None, :], cell, inv_cell))
        si, sj = sp[i], sp[j]
        thr = cut2[si.clamp(min=0)[:, None], sj.clamp(min=0)]
        valid = (d2 < thr) & (si >= 0)[:, None] & (sj >= 0)
        valid &= cols[None, :] != (window + i - ci0)[:, None]
        _fill(table, c0, valid, cand[..., 0], cand[..., 1], cand[..., 2], sj,
              max_neighbors)
    return table


def window_table(pos_sorted, sp_sorted, cell, cutoff_matrix,
                 max_neighbors: int, chunk: int, window: int, inv_cell=None):
    """Kernel #4 (replaces ``pallas_window_table``): for each sorted
    center i with chunk start c0 = (i // chunk) * chunk, the candidates
    are ext[c0, c0 + chunk + 2*window) with ext[k] = sorted[(k - window)
    mod n]; self is excluded by column. Returns (nbr_pos f32[n, K, 3],
    nbr_sp i32[n, K], cnt i32[n])."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if pos_sorted.device.type == "cpu":
        return window_table_plain(pos_sorted, sp_sorted, cell, cutoff_matrix,
                                  max_neighbors, chunk, window, inv_cell)
    from amof_tpu_torch import _build

    n = pos_sorted.shape[0]
    n_species = cutoff_matrix.shape[0]
    cut2 = (cutoff_matrix * cutoff_matrix).contiguous()
    _check(pos_sorted, (n, 3), torch.float32, "pos_sorted")
    _check(sp_sorted, (n,), torch.int32, "sp_sorted")
    for name, t in (("cell", cell), ("inv_cell", inv_cell),
                    ("cutoff_matrix", cut2)):
        _check(t, tuple(t.shape), torch.float32, name)
    if chunk < 1 or window < 0 or chunk + 2 * window >= n:
        raise ValueError("need chunk >= 1 and chunk + 2*window < n")
    _same_device(pos_sorted, sp_sorted, cell, inv_cell, cut2)
    nbr_pos = torch.empty((n, max_neighbors, 3), dtype=torch.float32,
                          device=pos_sorted.device)
    nbr_sp = torch.empty((n, max_neighbors), dtype=torch.int32,
                         device=pos_sorted.device)
    cnt = torch.empty(n, dtype=torch.int32, device=pos_sorted.device)
    err = _build.library().window_table_launch(
        pos_sorted.data_ptr(), sp_sorted.data_ptr(), cell.data_ptr(),
        inv_cell.data_ptr(), cut2.data_ptr(), n, n_species, max_neighbors,
        chunk, window, nbr_pos.data_ptr(), nbr_sp.data_ptr(), cnt.data_ptr(),
        _build.stream_ptr(pos_sorted.device),
    )
    _build.check(err, "window_table")
    LAUNCHES["window_table"] += 1
    return nbr_pos, nbr_sp, cnt


# --------------------------------------------------------------------------
# Kernel #3: 2-level (x-slab, y) windows, three candidate runs per chunk
# --------------------------------------------------------------------------

def window_table_slab_plain(centers, cand, starts, qbounds, cell,
                            cutoff_matrix, max_neighbors: int, chunk: int,
                            window: int, inv_cell=None):
    """Plain PyTorch version of ``window_table_slab``."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    m = centers.shape[0]
    dev = centers.device
    w = window
    cut2 = cutoff_matrix * cutoff_matrix
    table = _empty_table(m, max_neighbors, dev)
    offs = torch.arange(w, device=dev)
    per = max(1, _PLAIN_CELLS // (chunk * 3 * w))
    n_chunks = m // chunk
    for h0 in range(0, n_chunks, per):
        h1 = min(h0 + per, n_chunks)
        st = starts[h0:h1].long()  # [B, 3]
        j = (st[:, :, None] + offs[None, None, :]).reshape(h1 - h0, 3 * w)
        key = cand[5][j]
        qb = qbounds[h0:h1]  # [B, 3, 2]
        lo = qb[:, :, 0].repeat_interleave(w, dim=1)
        hi = qb[:, :, 1].repeat_interleave(w, dim=1)
        in_run = (key >= lo) & (key < hi)  # [B, 3W]
        cen = centers[h0 * chunk:h1 * chunk].reshape(h1 - h0, chunk, 8)
        cxyz = torch.stack([cand[0][j], cand[1][j], cand[2][j]], dim=-1)
        d2 = squared_norm(min_image_delta(
            cxyz[:, None, :, :] - cen[:, :, None, 0:3], cell, inv_cell))
        si = cen[..., 3].to(torch.int64)  # [B, C]
        sj = cand[3][j].to(torch.int64)  # [B, 3W]
        thr = cut2[si.clamp(min=0)[:, :, None], sj.clamp(min=0)[:, None, :]]
        valid = (d2 < thr) & (si >= 0)[:, :, None] & (sj >= 0)[:, None, :]
        valid &= in_run[:, None, :]
        valid &= cand[4][j][:, None, :] != cen[..., 4][:, :, None]
        rep = lambda a: a[:, None, :].expand(-1, chunk, -1).reshape(
            -1, 3 * w)
        _fill(table, h0 * chunk, valid.reshape(-1, 3 * w),
              rep(cxyz[..., 0]), rep(cxyz[..., 1]), rep(cxyz[..., 2]),
              rep(sj), max_neighbors)
    return table


def window_table_slab(centers, cand, starts, qbounds, cell, cutoff_matrix,
                      max_neighbors: int, chunk: int, window: int,
                      inv_cell=None):
    """Kernel #3 (replaces ``pallas_window_table_slab``): for each chunk
    of ``chunk`` centers, test the three runs cand[:, starts[c, r] +
    [0, window)), each masked to keys in [qbounds[c, r, 0],
    qbounds[c, r, 1]); self excluded by global index (row 4). Returns
    (nbr_pos f32[M, K, 3], nbr_sp i32[M, K], cnt i32[M])."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if centers.device.type == "cpu":
        return window_table_slab_plain(centers, cand, starts, qbounds, cell,
                                       cutoff_matrix, max_neighbors, chunk,
                                       window, inv_cell)
    from amof_tpu_torch import _build

    m = centers.shape[0]
    m2 = cand.shape[1]
    n_chunks = m // chunk
    n_species = cutoff_matrix.shape[0]
    cut2 = (cutoff_matrix * cutoff_matrix).contiguous()
    if chunk < 1 or m % chunk or window < 1 or window > m2:
        raise ValueError("need M % chunk == 0 and 1 <= window <= M2")
    _check(centers, (m, 8), torch.float32, "centers")
    _check(cand, (8, m2), torch.float32, "cand")
    _check(starts, (n_chunks, 3), torch.int32, "starts")
    _check(qbounds, (n_chunks, 3, 2), torch.float32, "qbounds")
    for name, t in (("cell", cell), ("inv_cell", inv_cell),
                    ("cutoff_matrix", cut2)):
        _check(t, tuple(t.shape), torch.float32, name)
    _same_device(centers, cand, starts, qbounds, cell, inv_cell, cut2)
    dev = centers.device
    nbr_pos = torch.empty((m, max_neighbors, 3), dtype=torch.float32,
                          device=dev)
    nbr_sp = torch.empty((m, max_neighbors), dtype=torch.int32, device=dev)
    cnt = torch.empty(m, dtype=torch.int32, device=dev)
    err = _build.library().window_table_slab_launch(
        centers.data_ptr(), cand.data_ptr(), starts.data_ptr(),
        qbounds.data_ptr(), cell.data_ptr(), inv_cell.data_ptr(),
        cut2.data_ptr(), m, m2, n_species, max_neighbors, chunk, window,
        nbr_pos.data_ptr(), nbr_sp.data_ptr(), cnt.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "window_table_slab")
    LAUNCHES["window_table_slab"] += 1
    return nbr_pos, nbr_sp, cnt


def _check(t, shape, dtype, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts):
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")
