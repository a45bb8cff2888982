"""
Two-level (x-slab, y-sorted) neighbour-table windows: the candidate
reduction for the BAD/CN table pass.

Counterpart of ``amof_tpu/ops/slab_table.py``. Sorting atoms by
(x-slab, fractional y) bounds candidates in both axes: a chunk of
consecutive sorted centers lies in one slab and spans a small y-range, so
its true neighbours live in three contiguous runs (slabs sx-1, sx, sx+1,
each y-windowed). ``build_slab_layout`` builds those runs per frame;
``window_table_slab`` (kernel #3) compacts them.

Exactness contract, as in the JAX package:
  * geometric (static, ``slab_plan``): slab width >= max cutoff along the
    x perpendicular and ry = max cutoff / y-perpendicular width, over all
    frames (NPT-safe); no valid plan -> the caller keeps the 1-level
    window;
  * per frame (``missed``): every (chunk, run) candidate range must fit
    the static window and every slab's population its static capacity;
    a violation raises the flag and the caller falls back.

The layout is built with stable sorts and searchsorted, with the JAX
package's float32 expressions in the same order, so ``centers``,
``cand``, ``starts``, ``qbounds`` and ``missed`` equal its own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from amof_tpu_torch.ops.pair_engine import cn_from_table, inverse_cell, matvec3


class SlabPlan(NamedTuple):
    """Static plan for the 2-level table."""
    nsx: int        # x-slab count
    cap: int        # center slots per slab (multiple of chunk)
    chunk: int      # centers per kernel step
    window: int     # candidate run capacity (multiple of 128)
    ry: float       # fractional-y neighbor reach (cutoff / w0y)
    yi: float       # y-image duplication width (>= ry)
    m_centers: int  # nsx * cap
    m_cand: int     # candidate array length (3 * n)
    n_atoms: int    # input row count the plan was built for


def slab_plan(cells, rc_max: float, n_atoms: int, chunk: int = 16,
              pad_limit: float = 1.6, positions=None,
              species_idx=None) -> Optional[SlabPlan]:
    """Build the static 2-level plan, or None when the geometry/count
    makes the 1-level window a better fit.

    ``cells`` may be [3, 3] or [F, 3, 3]; widths are minimized over
    frames so one plan serves an NPT trajectory.

    When ``positions`` ([F, N, 3] host array, optionally with
    ``species_idx`` [N] marking pad rows as -1) is given, the per-slab
    capacity is sized from the ACTUAL max slab population over frames
    instead of the uniform-density estimate — required whenever the
    density is structured along x (interfaces, crystals). Either way a
    frame that overflows the static capacity raises the dynamic
    ``missed`` flag and the caller falls back to the 1-level table.
    """
    cells = np.asarray(cells, np.float64)
    if cells.ndim == 2:
        cells = cells[None]
    widths = []
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        cr = np.cross(cells[:, b], cells[:, c])
        v = np.abs(np.einsum("fi,fi->f", cells[:, a], cr))
        widths.append(float((v / np.linalg.norm(cr, axis=1)).min()))
    if rc_max <= 0:
        return None
    nsx = int(widths[0] / rc_max)
    if nsx < 3:
        return None
    ry = rc_max / widths[1] + 1e-6
    if 2.0 * ry >= 0.5:  # y reach comparable to the cell: no gain
        return None
    yi = float(np.ceil(ry / 1e-3) * 1e-3)
    pop = n_atoms / nsx
    if positions is not None:
        pos = np.asarray(positions, np.float32)
        if pos.ndim == 2:
            pos = pos[None]
        n_f = pos.shape[0]
        # cap the host pass at 64 evenly-spaced frames; unsampled
        # frames that clump harder flag `missed` and fall back
        sel = (np.linspace(0, n_f - 1, min(n_f, 64)).astype(int)
               if n_f > 64 else np.arange(n_f))
        inv = np.linalg.inv(cells.astype(np.float64))
        max_pop = 0
        n_real = pos.shape[1]
        if species_idx is not None:
            realm = np.asarray(species_idx) >= 0
            n_real = int(realm.sum())
        for f in sel:
            fx = pos[f] @ inv[f if inv.shape[0] == n_f else 0]
            fx = fx[:, 0] - np.floor(fx[:, 0])
            if species_idx is not None:
                fx = fx[realm]
            sl = np.minimum((fx * nsx).astype(np.int64), nsx - 1)
            max_pop = max(max_pop, int(np.bincount(
                sl, minlength=nsx
            ).max()))
        n_pads = n_atoms - n_real
        cap = (max_pop + n_pads / nsx
               + 3.0 * np.sqrt(max(max_pop, 1.0)) + 8)
        pop = max(pop, float(max_pop))  # window sizing sees the clump
    else:
        cap = pop + 5.0 * np.sqrt(max(pop, 1.0)) + 16
    cap = int(-(-cap // chunk) * chunk)
    m_centers = nsx * cap
    if m_centers < n_atoms:
        cap += int(-(-(n_atoms - m_centers) // (nsx * chunk)) * chunk)
        m_centers = nsx * cap
    if m_centers > pad_limit * n_atoms:
        return None
    # run capacity: chunk's own span + 2*ry reach, images add <= 2*yi
    mean_r = (chunk + 2.0 * ry * pop) * (1.0 + 2.0 * yi)
    w_est = mean_r + 6.0 * np.sqrt(max(mean_r, 1.0)) + 16
    window = int(-(-(w_est + 127) // 128) * 128)
    m_cand = int(-(-(3 * n_atoms) // 128) * 128)
    if 3 * window >= m_cand or window >= n_atoms:
        return None
    return SlabPlan(nsx, cap, chunk, window, float(ry), yi,
                    m_centers, m_cand, n_atoms)


def _pad_spread(real):
    """Synthetic (fx, fy) for pad rows: spread uniformly BY PAD RANK so
    sizing sees them diluted (pads sit in contiguous runs between species
    blocks; keying off the row index would cluster them in one slab)."""
    not_real = (~real).to(torch.float32)
    rank = torch.cumsum(not_real, 0) - 1.0
    n_pads = torch.clamp(not_real.sum(), min=1.0)
    fx = (rank + 0.5) / n_pads
    fy = torch.remainder(rank * 0.6180339887, 1.0)
    return fx, fy


def _sort_rows(keys, *cols):
    """Stable sort of ``keys`` carrying the payload columns along."""
    keys_s, order = torch.sort(keys, stable=True)
    return (keys_s,) + tuple(c[order] for c in cols)


def slab_populations(slab, nsx: int):
    """Rows in each of the ``nsx`` slabs, int64 [nsx] (``slab`` in
    [0, nsx)): a fixed-size add, where ``bincount`` would read the
    largest slab back from the card."""
    slab = slab.long()
    pop = torch.zeros(nsx, dtype=torch.int64, device=slab.device)
    return pop.index_add_(0, slab, torch.ones_like(slab))


def build_slab_layout(positions, species_idx, cell, plan: SlabPlan,
                      inv_cell=None):
    """Per-frame construction of the 2-level layout.

    Returns:
      centers  f32[M, 8]  columns (x, y, z, sp, gidx, fy, 0, 0) in
               slab-aligned slot order (sp == -1 marks filler slots)
      cand     f32[8, M2] rows (x, y, z, sp, gidx, key, 0, 0) sorted by
               the stride-3 y-image key
      starts   i32[n_chunks, 3]   128-aligned run starts
      qbounds  f32[n_chunks, 3, 2] key-range [lo, hi) per run
      missed   bool[]  capacity/coverage violation (results incomplete)
    """
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    dev = positions.device
    f32 = torch.float32
    n = positions.shape[0]
    nsx, cap, chunk = plan.nsx, plan.cap, plan.chunk
    w = plan.window
    m = plan.m_centers
    m2 = plan.m_cand
    frac = matvec3(positions, inv_cell)
    fx = frac[:, 0] - torch.floor(frac[:, 0])
    fy = frac[:, 1] - torch.floor(frac[:, 1])
    real = species_idx >= 0
    sfx, sfy = _pad_spread(real)
    fx = torch.where(real, fx, sfx)
    fy = torch.where(real, fy, sfy)
    slab = torch.clamp((fx * nsx).to(torch.int32), max=nsx - 1)
    slab_f = slab.to(f32)
    gidx = torch.arange(n, dtype=f32, device=dev)
    sp_f = species_idx.to(f32)

    # ---- slab populations + filler placement (all input rows count)
    pop = slab_populations(slab, nsx)
    missed = (pop > cap).any()
    deficit = torch.clamp(cap - pop, min=0)
    cum_def = torch.cumsum(deficit, 0)
    n_extra = m - n
    t = torch.arange(n_extra, device=dev)
    extra_slab = torch.searchsorted(cum_def, t, right=True)
    extra_slab = torch.clamp(extra_slab, max=nsx - 1).to(f32)

    # ---- centers: key = slab*2 + fy (reals), slab*2 + 1 + eps (pads)
    key_real = slab_f * 2.0 + torch.where(real, fy, 1.0 + sfy * 0.5)
    # divisors are device tensors: CUDA turns division by a host scalar
    # into a multiply by its reciprocal, which rounds differently
    n_extra_f = torch.full((), float(max(n_extra, 1)), dtype=f32, device=dev)
    key_extra = extra_slab * 2.0 + 1.5 + 0.5 * (t.to(f32) + 0.5) / n_extra_f
    zeros_e = torch.zeros(n_extra, dtype=f32, device=dev)
    neg_e = torch.full((n_extra,), -1.0, dtype=f32, device=dev)
    ch = lambda a: torch.cat([a, zeros_e])
    sorted_c = _sort_rows(
        torch.cat([key_real, key_extra]),
        ch(positions[:, 0]), ch(positions[:, 1]), ch(positions[:, 2]),
        torch.cat([sp_f, neg_e]), torch.cat([gidx, neg_e]), ch(fy),
    )
    zeros_m = torch.zeros(m, dtype=f32, device=dev)
    centers = torch.stack(list(sorted_c[1:]) + [zeros_m, zeros_m], dim=1)
    sp_sorted = sorted_c[4]
    fy_sorted = sorted_c[6]

    # ---- candidates: stride-3 keys with +-1 y-wrap images (reals only)
    yi = plan.yi
    big = torch.full_like(fy, 3e9)
    key_main = torch.where(real, slab_f * 3.0 + 1.0 + fy, big)
    key_lo = torch.where(real & (fy > 1.0 - yi), slab_f * 3.0 + fy, big)
    key_hi = torch.where(real & (fy < yi), slab_f * 3.0 + 2.0 + fy, big)
    pad_b = m2 - 3 * n  # 128-alignment tail (plan.m_cand)
    pz = torch.zeros(pad_b, dtype=f32, device=dev)
    pneg = torch.full((pad_b,), -1.0, dtype=f32, device=dev)
    c3 = lambda a: torch.cat([a, a, a, pz])
    sorted_b = _sort_rows(
        torch.cat([key_main, key_lo, key_hi,
                   torch.full((pad_b,), 5e9, dtype=f32, device=dev)]),
        c3(positions[:, 0]), c3(positions[:, 1]), c3(positions[:, 2]),
        torch.cat([sp_f, sp_f, sp_f, pneg]),
        torch.cat([gidx, gidx, gidx, pneg]),
    )
    kb = sorted_b[0]
    zeros_m2 = torch.zeros(m2, dtype=f32, device=dev)
    cand = torch.stack(list(sorted_b[1:]) + [kb, zeros_m2, zeros_m2], dim=0)

    # ---- per-chunk run ranges
    n_chunks = m // chunk
    live = sp_sorted >= 0
    # constants as scalars and device fills, never copies from the host
    inf = float("inf")
    fy_lo = torch.where(live, fy_sorted, inf).reshape(n_chunks, chunk).amin(1)
    fy_hi = torch.where(live, fy_sorted, -inf).reshape(n_chunks, chunk).amax(1)
    sx = torch.arange(n_chunks, device=dev) // (cap // chunk)
    qlo_y = fy_lo - plan.ry
    qhi_y = fy_hi + plan.ry
    offs = torch.arange(-1, 2, device=dev)
    slab_r = torch.remainder(sx[:, None] + offs[None, :], nsx)  # [C, 3]
    base = slab_r.to(f32) * 3.0 + 1.0
    klo = base + qlo_y[:, None]
    khi = base + qhi_y[:, None]
    empty = ~torch.isfinite(qlo_y)
    klo = torch.where(empty[:, None], torch.full_like(klo, 4e9), klo)
    khi = torch.where(empty[:, None], torch.full_like(khi, 4e9), khi)
    st = torch.searchsorted(kb, klo.reshape(-1)).to(torch.int32)
    en = torch.searchsorted(kb, khi.reshape(-1)).to(torch.int32)
    st_al = torch.bitwise_and(st, ~127)
    missed = missed | (en - st_al > w).any()
    st_al = torch.clamp(st_al, 0, m2 - w).reshape(n_chunks, 3)
    qbounds = torch.stack([klo, khi], dim=-1)
    return centers, cand, st_al.contiguous(), qbounds.contiguous(), missed


def frame_neighbor_payload_table_slab(positions, cell, species_idx,
                                      cutoff_matrix, max_neighbors: int,
                                      plan: SlabPlan, emit_cn: bool = False,
                                      inv_cell=None, emit_missed: bool = False):
    """2-level drop-in for the 1-level sorted table (full i-range):
    (nbr_pos [M, K, 3], nbr_sp [M, K], nbr_cnt [M] (clipped), flag,
    center_pos [M, 3], center_sp [M] [, cn [S, S]] [, missed]) with M =
    plan.m_centers center slots (fillers carry species -1 and empty
    tables). Neighbour SETS match the full table; slot order is
    run-major."""
    from amof_tpu_torch.ops import neighbor_kernel

    if positions.shape[0] != plan.n_atoms:
        raise ValueError(f"plan built for {plan.n_atoms} atoms, got "
                         f"{positions.shape[0]}")
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    centers, cand, starts, qbounds, missed = build_slab_layout(
        positions, species_idx, cell, plan, inv_cell=inv_cell
    )
    nbr_pos, nbr_sp, cnt = neighbor_kernel.window_table_slab(
        centers, cand, starts, qbounds, cell, cutoff_matrix,
        max_neighbors, plan.chunk, plan.window, inv_cell=inv_cell,
    )
    center_pos = centers[:, 0:3]
    center_sp = centers[:, 3].to(torch.int32)
    flag = missed | (cnt > max_neighbors).any()
    out = (nbr_pos, nbr_sp, cnt.clamp(max=max_neighbors), flag,
           center_pos, center_sp)
    if emit_cn:
        out = out + (cn_from_table(nbr_sp, center_sp,
                                   cutoff_matrix.shape[0]),)
    if emit_missed:
        out = out + (missed,)
    return out
