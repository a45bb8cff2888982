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

Both launch ``csrc/window_table.cu`` (blocks of up to 16 centers of one
chunk, candidate columns compacted in column order before any test; see
its header) for CUDA tensors and run the plain version for CPU tensors.
Outputs are (nbr_pos f32[M, K, 3], nbr_sp i32[M, K], cnt i32[M]) (on the
card: views of one allocation); empty slots hold position 0 and species
-1; ``cnt`` counts every valid candidate, so ``cnt > K`` flags overflow.
``window_table_slab_compact`` and ``window_table_compact`` are the plain
twins of the kernels' decompositions (#3: in-range columns; #4: columns
within the exact fractional-x reach of the block's centers; both skip
blocks of fillers), for the tests only.

The JAX wrappers' TPU gates do not exist here: no 128-lane payload limit
(``1 + 4K <= 128``), no VMEM budget, no 128-alignment of chunk or window.
Any K the retry ladder asks for (up to 1024) runs on the card.
"""

from __future__ import annotations

import math

import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.ops.pair_engine import (
    first_k_slots,
    inverse_cell,
    min_image_delta,
    squared_norm,
)

_PLAIN_CELLS = 1 << 24  # candidate tests per plain-version batch


# the blocks both kernels share, as csrc/window_table.cu fixes them
SLAB_PASS = 1024        # columns a compaction pass (SLAB_PASS)
SLAB_MAX_CPB = 16       # centers a block, 4 a warp (SLAB_MAX_CPB)
SLAB_TILE_SLOTS = 1024  # cpb * K slots a block holds (SLAB_TILE_SLOTS)
_F32, _I32 = torch.float32, torch.int32


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


def _stage_passes(kept, cap, flush):
    """Steps 2 and 3 of both kernels on one block: the kept columns
    (``kept`` bool over the window) staged in column order, pass by pass
    of SLAB_PASS columns, into ``cap`` places; ``flush(columns)`` tests
    what is staged before a pass that would overflow it, and at the
    end."""
    staged = kept.new_zeros(0, dtype=torch.int64)
    for p0 in range(0, kept.numel(), SLAB_PASS):
        cols = kept[p0:p0 + SLAB_PASS].nonzero()[:, 0] + p0
        if staged.numel() + cols.numel() > cap:
            flush(staged)
            staged = staged[:0]
        staged = torch.cat([staged, cols])
    if staged.numel():
        flush(staged)


def _fill_slots(table, r0, count, valid, xyz, sj):
    """A flush's slots: row r0 + q's valid columns (``valid`` [rows, C])
    take its next slots in column order, after its ``count`` so far (which
    grows by every valid column, written or not)."""
    nbr_pos, nbr_sp, _ = table
    slot = count[:, None] + torch.cumsum(valid, dim=1) - 1
    q, c = (valid & (slot < nbr_sp.shape[1])).nonzero(as_tuple=True)
    nbr_pos[r0 + q, slot[q, c]] = xyz[c]
    nbr_sp[r0 + q, slot[q, c]] = sj[c].to(torch.int32)
    count.add_(valid.sum(dim=1))


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


# kernel #4's decomposition and cut, as csrc/window_table.cu fixes them
CUT_SLACK = 2.0 ** -20  # the cut's relative margin (CUT_SLACK)


def window_centers_per_block(chunk: int, max_neighbors: int) -> int:
    """Kernel #4's centers a block: min(SLAB_MAX_CPB, chunk, 1024 // K),
    at least 1. A chunk is ceil(chunk / cpb) blocks, the last one short
    when cpb does not divide it."""
    cpb = SLAB_TILE_SLOTS // max_neighbors if max_neighbors > 0 else \
        SLAB_MAX_CPB
    return max(1, min(cpb, SLAB_MAX_CPB, chunk))


def window_blocks(n: int, chunk: int, max_neighbors: int, device=None):
    """Kernel #4's blocks in launch order: (first row, rows, chunk start)
    i64[B] each."""
    cpb = window_centers_per_block(chunk, max_neighbors)
    c0 = torch.arange(0, n, chunk, device=device)
    q0 = torch.arange(0, chunk, cpb, device=device)
    first = (c0[:, None] + q0[None, :]).reshape(-1)
    c0 = c0[:, None].expand(-1, q0.numel()).reshape(-1)
    on = first < n
    first, c0 = first[on], c0[on]
    rows = torch.clamp(torch.minimum(c0 + chunk - first, n - first),
                       max=cpb)
    return first, rows, c0


def window_reach(cell, cutoff_matrix):
    """(R_x, R_y, R_z) of the cuts (csrc/window_table.cu header): (rc +
    2^-20 (rc + L)) / w0 in double along each axis, rc the root of the
    largest f32 squared cutoff, L the sum of the cell rows' lengths, w0
    the cell's width across the plane of the other two rows; inf or NaN
    for a degenerate cell (nothing is then dropped)."""
    m2 = float((cutoff_matrix * cutoff_matrix).max().clamp(min=0))
    c = [float(x) for x in cell.reshape(-1).tolist()]
    cross = ((c[4] * c[8] - c[5] * c[7], c[5] * c[6] - c[3] * c[8],
              c[3] * c[7] - c[4] * c[6]),
             (c[7] * c[2] - c[8] * c[1], c[8] * c[0] - c[6] * c[2],
              c[6] * c[1] - c[7] * c[0]),
             (c[1] * c[5] - c[2] * c[4], c[2] * c[3] - c[0] * c[5],
              c[0] * c[4] - c[1] * c[3]))
    norm = lambda x, y, z: math.sqrt((x * x + y * y) + z * z)
    det = abs((c[0] * cross[0][0] + c[1] * cross[0][1])
              + c[2] * cross[0][2])
    el = (norm(*c[0:3]) + norm(*c[3:6])) + norm(*c[6:9])
    rc = math.sqrt(m2)
    num = rc + CUT_SLACK * (rc + el)
    out = []
    for x in cross:
        nx = norm(*x)
        w0 = det / nx if nx > 0 else math.nan
        out.append(num / w0 if w0 > 0 else
                   (math.inf if w0 == 0 else math.nan))
    return tuple(out)


def _frac(pos, inv_cell, axis):
    """(u, s) of the cuts along ``axis`` in double (the header's u and
    s)."""
    x = pos.double() * inv_cell[:, axis].double()
    return ((x[:, 0] + x[:, 1]) + x[:, 2],
            (x[:, 0].abs() + x[:, 1].abs()) + x[:, 2].abs())


def window_prefilter(pos_c, pos_j, inv_cell, reach):
    """Kernel #4's pair prefilter, bool[C, J]: False where a center of
    ``pos_c`` and a column of ``pos_j`` lie further apart in fractional y
    or z than the f32 thresholds allow (no such pair passes the exact
    test; csrc/window_table.cu header)."""
    near = torch.ones((pos_c.shape[0], pos_j.shape[0]), dtype=torch.bool,
                      device=pos_c.device)
    fj = {ax: _frac(pos_j, inv_cell, ax) for ax in (1, 2)}
    b = (CUT_SLACK * torch.maximum(fj[1][1], fj[2][1])).float()
    for ax, (uj, _) in fj.items():
        uc, sc = _frac(pos_c, inv_cell, ax)
        a = (reach[ax] + CUT_SLACK * sc).float()
        t = uj.float()[None, :] - uc.float()[:, None]
        t = (t - torch.round(t)).abs()
        near &= ~(t > a[:, None] + b[None, :])
    return near


def window_kept_columns(pos_sorted, sp_sorted, cell, cutoff_matrix,
                        max_neighbors: int, chunk: int, window: int,
                        inv_cell=None):
    """Kernel #4's fractional-x cut, block by block (the CUDA source's
    header argues it): (kept bool[B, chunk + 2W], live i64[B], first, rows,
    c0). Column col of block b is sorted row (c0 - W + col) mod n; it is
    kept iff it is real and within R + 2^-20 (s_col + smax) of the arc
    that the block's live centers span in fractional x. ``live`` counts a
    block's live centers (0: the kernel skips it)."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = pos_sorted.shape[0]
    dev = pos_sorted.device
    first, rows, c0 = window_blocks(n, chunk, max_neighbors, dev)
    cpb = window_centers_per_block(chunk, max_neighbors)
    u, s = _frac(pos_sorted, inv_cell, 0)
    q = torch.arange(cpb, device=dev)
    idx = torch.clamp(first[:, None] + q, max=n - 1)
    on = (q[None, :] < rows[:, None]) & (sp_sorted[idx] >= 0)
    live = on.sum(dim=1)
    anchor = u[idx].gather(1, on.int().argmax(dim=1, keepdim=True))
    d = u[idx] - anchor
    d = d - torch.round(d)
    inf = torch.full_like(d, math.inf)
    lo = torch.where(on, d, inf).amin(dim=1)
    hi = torch.where(on, d, -inf).amax(dim=1)
    mid = anchor[:, 0] + 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    smax = torch.where(on, s[idx], torch.zeros_like(d)).amax(dim=1)
    reach = window_reach(cell, cutoff_matrix)[0]
    cols = torch.arange(chunk + 2 * window, device=dev)
    j = (c0[:, None] - window + cols[None, :]) % n
    t = u[j] - mid[:, None]
    gap = (t - torch.round(t)).abs() - half[:, None]
    kept = (sp_sorted[j] >= 0) & ~(gap > reach + CUT_SLACK
                                   * (s[j] + smax[:, None]))
    return kept, live, first, rows, c0


def window_table_compact(pos_sorted, sp_sorted, cell, cutoff_matrix,
                         max_neighbors: int, chunk: int, window: int,
                         inv_cell=None):
    """Plain twin of kernel #4's decomposition, for tests (never on the
    card's path). Block by block, as the kernel runs: a block
    (``window_blocks``) with no live center leaves its rows empty;
    otherwise the columns its cut keeps (``window_kept_columns``) are
    staged in column order, as kernel #3 stages its kept columns, and each
    live center's slots fill from them in order, a pair the prefilter
    (``window_prefilter``) drops never valid. The tests hold it equal to
    the plain version."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = pos_sorted.shape[0]
    k_cap = max_neighbors
    cut2 = cutoff_matrix * cutoff_matrix
    width = chunk + 2 * window
    table = _empty_table(n, k_cap, pos_sorted.device)
    kept, live, first, rows, c0 = window_kept_columns(
        pos_sorted, sp_sorted, cell, cutoff_matrix, k_cap, chunk, window,
        inv_cell)
    reach = window_reach(cell, cutoff_matrix)
    for b in torch.nonzero(live > 0)[:, 0].tolist():
        r0, nr, cb = int(first[b]), int(rows[b]), int(c0[b])
        cen = pos_sorted[r0:r0 + nr]
        si = sp_sorted[r0:r0 + nr].long()
        self_col = window + r0 - cb + torch.arange(nr, device=cen.device)
        count = torch.zeros(nr, dtype=torch.int64, device=cen.device)

        def flush(cols):
            j = (cb - window + cols) % n
            xyz, sj = pos_sorted[j], sp_sorted[j].long()
            d2 = squared_norm(min_image_delta(
                xyz[None, :, :] - cen[:, None, :], cell, inv_cell))
            thr = cut2[si.clamp(min=0)[:, None], sj.clamp(min=0)[None, :]]
            valid = ((d2 < thr) & (si >= 0)[:, None] & (sj >= 0)[None, :]
                     & (cols[None, :] != self_col[:, None])
                     & window_prefilter(cen, xyz, inv_cell, reach))
            _fill_slots(table, r0, count, valid, xyz, sj)

        _stage_passes(kept[b], min(width, SLAB_PASS), flush)
        table[2][r0:r0 + nr] = count.to(torch.int32)
    return table


def window_table(pos_sorted, sp_sorted, cell, cutoff_matrix,
                 max_neighbors: int, chunk: int, window: int, inv_cell=None):
    """Kernel #4 (replaces ``pallas_window_table``): for each sorted
    center i with chunk start c0 = (i // chunk) * chunk, the candidates
    are ext[c0, c0 + chunk + 2*window) with ext[k] = sorted[(k - window)
    mod n]; self is excluded by column. Returns (nbr_pos f32[n, K, 3],
    nbr_sp i32[n, K], cnt i32[n]).

    On the card the three outputs are views of one allocation, the kernel
    squares the cutoffs and computes its cut itself: the launch is the
    call's only device work."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if pos_sorted.is_cpu:
        return window_table_plain(pos_sorted, sp_sorted, cell, cutoff_matrix,
                                  max_neighbors, chunk, window, inv_cell)
    from amof_tpu_torch import _build

    n, k, s = pos_sorted.shape[0], max_neighbors, cutoff_matrix.shape[0]
    if (chunk < 1 or window < 0 or chunk + 2 * window >= n or k < 0
            or n >= 1 << 24):
        raise ValueError("need chunk >= 1, window >= 0, chunk + 2*window < "
                         "n < 2^24 and K >= 0")
    dev = pos_sorted.get_device()
    for t, shape, dtype, name in (
            (pos_sorted, (n, 3), _F32, "pos_sorted"),
            (sp_sorted, (n,), _I32, "sp_sorted"),
            (cell, (3, 3), _F32, "cell"), (inv_cell, (3, 3), _F32, "inv_cell"),
            (cutoff_matrix, (s, s), _F32, "cutoff_matrix")):
        if (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                or t.get_device() != dev):
            _check(t, shape, dtype, name)
            raise ValueError("all inputs must be on one device")
    buf = torch.empty(n * (4 * k + 1), dtype=_I32, device=pos_sorted.device)
    err = _build.library().window_table_launch(
        pos_sorted.data_ptr(), sp_sorted.data_ptr(), cell.data_ptr(),
        inv_cell.data_ptr(), cutoff_matrix.data_ptr(), buf.data_ptr(), n, s,
        k, chunk, window, _build.stream_ptr(pos_sorted))
    _build.check(err, "window_table")
    tracing.count("launch.window_table")  # CPU calls do not count
    return _table_views(buf, n, k)


def window_table_geometry(n: int, chunk: int, max_neighbors: int,
                          window: int, n_species: int) -> dict:
    """What kernel #4's launch gets for n sorted centers on the current
    card: blocks, threads, cpb (centers a block), cpw (centers a warp),
    bpc (blocks a chunk), cap (staged columns), pass_columns, smem_bytes
    (dynamic), registers, static_smem_bytes and blocks_per_sm, as the CUDA
    source computes them."""
    import ctypes

    from amof_tpu_torch import _build

    geo = (ctypes.c_int * 11)()
    _build.check(_build.library().window_table_geometry(
        n, chunk, max_neighbors, window, n_species, geo),
        "window_table_geometry")
    keys = ("blocks", "threads", "cpb", "cpw", "bpc", "cap", "pass_columns",
            "smem_bytes", "registers", "static_smem_bytes", "blocks_per_sm")
    return dict(zip(keys, geo))


# --------------------------------------------------------------------------
# Kernel #3: 2-level (x-slab, y) windows, three candidate runs per chunk
# --------------------------------------------------------------------------

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
    table = _empty_table(m, k_cap, centers.device)
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
            _fill_slots(table, r0, count, valid, xyz, sj)

        _stage_passes(kept[ch], cap, flush)
        table[2][r0:r0 + cpb] = count.to(torch.int32)
    return table


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
    tracing.count("launch.window_table_slab")  # CPU calls do not count
    return _table_views(buf, m, k)


def _table_views(buf, m, k):
    """(nbr_pos, nbr_sp, cnt) as views of a kernel's one output buffer of
    M * (4K + 1) int32 words."""
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

