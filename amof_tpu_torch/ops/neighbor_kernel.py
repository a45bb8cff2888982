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
tensors. Outputs are (nbr_pos f32[M, K, 3], nbr_sp i32[M, K], cnt
i32[M]) (kernel #3's on the card: views of one allocation); empty slots
hold position 0 and species -1; ``cnt`` counts every valid candidate, so
``cnt > K`` flags overflow. ``window_table_slab_compact`` is the plain
twin of kernel #3's decomposition (compacted in-range columns, blocks of
fillers skipped), for the tests only.

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
        _build.stream_ptr(pos_sorted),
    )
    _build.check(err, "window_table")
    LAUNCHES["window_table"] += 1
    return nbr_pos, nbr_sp, cnt


# --------------------------------------------------------------------------
# Kernel #3: 2-level (x-slab, y) windows, three candidate runs per chunk
# --------------------------------------------------------------------------

# kernel #3's decomposition, as csrc/window_table.cu fixes it
SLAB_PASS = 1024        # columns a compaction pass (SLAB_PASS)
SLAB_MAX_CPB = 16       # centers a block, 4 a warp (SLAB_MAX_CPB)
SLAB_TILE_SLOTS = 1024  # cpb * K slots a block holds (SLAB_TILE_SLOTS)


def slab_centers_per_block(chunk: int, max_neighbors: int) -> int:
    """Kernel #3's centers a block: the largest divisor of ``chunk`` up
    to SLAB_MAX_CPB whose slots fit the output tile (1 when K alone
    needs more)."""
    for d in range(min(chunk, SLAB_MAX_CPB), 1, -1):
        if chunk % d == 0 and d * max_neighbors <= SLAB_TILE_SLOTS:
            return d
    return 1


def slab_kept_columns(cand, starts, qbounds, window: int):
    """(kept bool[n_chunks, 3W], rows i64[n_chunks, 3W]): column c of
    chunk ch is row starts[ch, c // W] + c % W of ``cand``, kept iff its
    key lies in its run's [qbounds[ch, r, 0], qbounds[ch, r, 1])."""
    offs = torch.arange(window, device=cand.device)
    rows = (starts.long()[:, :, None] + offs).reshape(starts.shape[0], -1)
    key = cand[5][rows]
    lo = qbounds[:, :, 0].repeat_interleave(window, dim=1)
    hi = qbounds[:, :, 1].repeat_interleave(window, dim=1)
    return (key >= lo) & (key < hi), rows


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


def window_table_slab_compact(centers, cand, starts, qbounds, cell,
                              cutoff_matrix, max_neighbors: int, chunk: int,
                              window: int, inv_cell=None):
    """Plain twin of kernel #3's decomposition, for tests (never on the
    card's path). Block by block, as the kernel runs: a block of
    ``slab_centers_per_block`` centers of one chunk with no live center
    leaves its rows empty; otherwise its chunk's kept columns
    (``slab_kept_columns``) are staged in column order, pass by pass of
    SLAB_PASS columns, into min(3W, SLAB_PASS) places, flushed before a
    pass that would overflow them; each flush fills every live center's
    next slots from the staged columns in order, its count carried from
    flush to flush. The tests hold it equal to the plain version."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    m = centers.shape[0]
    k_cap = max_neighbors
    cut2 = cutoff_matrix * cutoff_matrix
    cpb = slab_centers_per_block(chunk, k_cap)
    cap = min(3 * window, SLAB_PASS)
    nbr_pos, nbr_sp, cnt = table = _empty_table(m, k_cap, centers.device)
    kept, rows = slab_kept_columns(cand, starts, qbounds, window)
    for r0 in range(0, m, cpb):
        cen = centers[r0:r0 + cpb]
        si = cen[:, 3].to(torch.int64)
        if not bool((si >= 0).any()):
            continue  # a block of fillers only: empty rows
        ch = r0 // chunk
        count = torch.zeros(cpb, dtype=torch.int64, device=centers.device)

        def flush(cols):
            j = rows[ch, cols]
            xyz = cand[0:3, j].T
            sj = cand[3, j].to(torch.int64)
            d2 = squared_norm(min_image_delta(
                xyz[None, :, :] - cen[:, None, 0:3], cell, inv_cell))
            thr = cut2[si.clamp(min=0)[:, None], sj.clamp(min=0)[None, :]]
            valid = ((d2 < thr) & (si >= 0)[:, None] & (sj >= 0)[None, :]
                     & (cand[4, j][None, :] != cen[:, 4:5]))
            slot = count[:, None] + torch.cumsum(valid, dim=1) - 1
            q, c = (valid & (slot < k_cap)).nonzero(as_tuple=True)
            nbr_pos[r0 + q, slot[q, c]] = xyz[c]
            nbr_sp[r0 + q, slot[q, c]] = sj[c].to(torch.int32)
            count.add_(valid.sum(dim=1))

        staged = kept.new_zeros(0, dtype=torch.int64)
        for p0 in range(0, 3 * window, SLAB_PASS):
            cols = kept[ch, p0:p0 + SLAB_PASS].nonzero()[:, 0] + p0
            if staged.numel() + cols.numel() > cap:
                flush(staged)
                staged = staged[:0]
            staged = torch.cat([staged, cols])
        if staged.numel():
            flush(staged)
        cnt[r0:r0 + cpb] = count.to(torch.int32)
    return table


_F32, _I32 = torch.float32, torch.int32


def window_table_slab(centers, cand, starts, qbounds, cell, cutoff_matrix,
                      max_neighbors: int, chunk: int, window: int,
                      inv_cell=None):
    """Kernel #3 (replaces ``pallas_window_table_slab``): for each chunk
    of ``chunk`` centers, test the three runs cand[:, starts[c, r] +
    [0, window)), each masked to keys in [qbounds[c, r, 0],
    qbounds[c, r, 1]); self excluded by global index (row 4). Returns
    (nbr_pos f32[M, K, 3], nbr_sp i32[M, K], cnt i32[M]).

    The call is host-bound on the card, so its launch path is short: the
    kernel squares the cutoff matrix itself (the launch is the call's only
    device work), the three outputs are views of one allocation, and each
    input is checked with few tensor-property calls."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if centers.is_cpu:
        return window_table_slab_plain(centers, cand, starts, qbounds, cell,
                                       cutoff_matrix, max_neighbors, chunk,
                                       window, inv_cell)
    from amof_tpu_torch import _build

    m, m2, k = centers.shape[0], cand.shape[1], max_neighbors
    s = cutoff_matrix.shape[0]
    if chunk < 1 or m % chunk or not 1 <= window <= m2 or k < 0:
        raise ValueError("need M % chunk == 0, 1 <= window <= M2, K >= 0")
    n_chunks = m // chunk
    dev = centers.get_device()
    for t, shape, dtype, name in (
            (centers, (m, 8), _F32, "centers"), (cand, (8, m2), _F32, "cand"),
            (starts, (n_chunks, 3), _I32, "starts"),
            (qbounds, (n_chunks, 3, 2), _F32, "qbounds"),
            (cell, (3, 3), _F32, "cell"), (inv_cell, (3, 3), _F32, "inv_cell"),
            (cutoff_matrix, (s, s), _F32, "cutoff_matrix")):
        if (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                or t.get_device() != dev):
            _check(t, shape, dtype, name)
            raise ValueError("all inputs must be on one device")
    buf = torch.empty(m * (4 * k + 1), dtype=_I32, device=centers.device)
    err = _build.library().window_table_slab_launch(
        centers.data_ptr(), cand.data_ptr(), starts.data_ptr(),
        qbounds.data_ptr(), cell.data_ptr(), inv_cell.data_ptr(),
        cutoff_matrix.data_ptr(), buf.data_ptr(), m, m2, s, k, chunk, window,
        _build.stream_ptr(centers))
    _build.check(err, "window_table_slab")
    LAUNCHES["window_table_slab"] += 1
    return _slab_views(buf, m, k)


def _slab_views(buf, m, k):
    """(nbr_pos, nbr_sp, cnt) as views of the kernel's one output buffer
    of M * (4K + 1) int32 words."""
    return (buf.view(_F32).as_strided((m, k, 3), (3 * k, 3, 1)),
            buf.as_strided((m, k), (k, 1), 3 * m * k),
            buf.as_strided((m,), (1,), 4 * m * k))


def window_table_slab_geometry(m: int, chunk: int, max_neighbors: int,
                               window: int, n_species: int) -> dict:
    """What kernel #3's launch gets for M centers on the current card:
    blocks, threads, cpb (centers a block), cpw (centers a warp), cap
    (staged columns), pass_columns, smem_bytes (dynamic), registers,
    static_smem_bytes and blocks_per_sm, as the CUDA source computes
    them."""
    import ctypes

    from amof_tpu_torch import _build

    geo = (ctypes.c_int * 10)()
    _build.check(_build.library().window_table_slab_geometry(
        m, chunk, max_neighbors, window, n_species, geo),
        "window_table_slab_geometry")
    keys = ("blocks", "threads", "cpb", "cpw", "cap", "pass_columns",
            "smem_bytes", "registers", "static_smem_bytes", "blocks_per_sm")
    return dict(zip(keys, geo))


def _check(t, shape, dtype, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts):
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")
