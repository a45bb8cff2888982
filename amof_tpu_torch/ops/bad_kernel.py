"""
Bond-angle distribution of one frame: neighbour table -> every unordered
pair of a center's neighbour slots -> minimum-image angle -> histograms.

Counterpart of ``amof_tpu/ops/bad_kernel.py`` (XLA code there, not
Pallas, so plain PyTorch here). It emits two species-resolved tensors
from which every B-A-B spec of the reference's enumeration
(amof/bad.py:122-133) is a slice or a sum:

  * concrete[a, b, cn, theta]: angles with center species a and BOTH
    outer atoms of species b, bucketed by the center's count of
    b-species neighbours — spec (a, b);
  * center_any[a, cn, theta]: ALL angles at centers of species a,
    bucketed by the center's total neighbour count — spec (a, "X");
    summing over a gives ("X", "X").

The cn axis has K + 1 slots with ``by_cn`` (BadByCn) and size 1 without
(the fused step and ``Bad``). Counts accumulate in place (``index_add_``
of 0/1 weights into float64 over every slot pair, exact in any order and
with no read-back from the card): S^2 (K+1) bins reaches ~30M
slots at K 512, which must not be allocated per chunk.

The table comes from the 2-level slab windows (kernel #3), the 1-level
sorted window (kernel #4) or the full O(N^2) table, in that order of
preference; the returned flag covers capacity overflow and window misses.
"""

from __future__ import annotations

import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.ops import slab_table
from amof_tpu_torch.ops.pair_engine import (
    frame_cn_counts,
    frame_neighbor_payload_table,
    frame_neighbor_payload_table_sorted,
    inverse_cell,
    min_image_delta,
    sqrt_rn,
    squared_norm,
)

_ANGLE_CELLS = 1 << 24  # center x slot-pair entries per histogram batch


def frame_bad_counts(positions, cell, species_idx, cutoff_matrix,
                     n_species: int, dtheta: float, bins: int,
                     max_neighbors: int = 24, chunk: int = 256,
                     window: int = None, emit_cn: bool = False, slab=None,
                     inv_cell=None, emit_missed: bool = False,
                     by_cn: bool = False, out=None):
    """Angle histograms of one frame.

    ``slab`` (a ``slab_table.SlabPlan``) selects the 2-level table;
    otherwise ``window`` selects the 1-level sorted-window table (None,
    or a window too wide for N, uses the full table). Histograms are
    order-invariant, so every table gives the same counts. ``by_cn`` and
    ``out`` as in ``angle_histograms``.

    Returns:
        concrete  f32[S, S, C, bins]  (C = K + 1 with by_cn, else 1)
        center_any f32[S, C, bins]
        (float64 ``out`` accumulators instead when given)
        flag      bool[]  (capacity overflow, or a window miss)
        [, cn f32[S, S] when emit_cn: per-species-pair neighbour counts
         read off the table]
        [, missed bool[] when emit_missed: the window's coverage check
         alone, which a larger K cannot clear (False on the full table)]
    """
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = positions.shape[0]
    k_cap = max_neighbors
    if k_cap < 2:
        raise ValueError("angle triplets need max_neighbors >= 2")
    if window is not None and chunk + 2 * window >= n:
        window = None
    with tracing.span("bad.table"):
        if slab is not None:
            (nbr_pos, nbr_sp, _, flag, center_pos, center_sp,
             *extra) = slab_table.frame_neighbor_payload_table_slab(
                positions, cell, species_idx, cutoff_matrix, k_cap, slab,
                emit_cn=emit_cn, inv_cell=inv_cell, emit_missed=emit_missed,
            )
        elif window is not None:
            (nbr_pos, nbr_sp, _, flag, center_pos, center_sp,
             *extra) = frame_neighbor_payload_table_sorted(
                positions, cell, species_idx, cutoff_matrix, k_cap, chunk,
                window, emit_cn=emit_cn, inv_cell=inv_cell,
                emit_missed=emit_missed,
            )
        else:
            nbr_pos, nbr_sp, _, flag = frame_neighbor_payload_table(
                positions, cell, species_idx, cutoff_matrix, k_cap, chunk,
                inv_cell=inv_cell,
            )
            center_pos, center_sp = positions, species_idx.to(torch.int32)
            # the full table's CN comes from its own pair pass, exact even
            # when a center overflows K (as in the JAX package)
            extra = [frame_cn_counts(positions, cell, species_idx,
                                     cutoff_matrix, n_species, chunk,
                                     inv_cell=inv_cell)] if emit_cn else []
            if emit_missed:
                extra.append(torch.zeros((), dtype=torch.bool,
                                         device=positions.device))
    with tracing.span("bad.angles"):
        conc, any_ = angle_histograms(nbr_pos, nbr_sp, center_pos,
                                      center_sp, cell, inv_cell, n_species,
                                      dtheta, bins, by_cn=by_cn, out=out)
    return (conc, any_, flag, *extra)


def _accumulate(acc, keys, valid, spread):
    """acc[k] += 1 for every key where ``valid`` (acc a flat float64
    tensor): one add over every entry, the mask as float64 weights, so
    nothing reads a count back from the card (a CUDA graph can hold it).
    The counts stay exact integers in any order (x + 0.0 == x). A masked
    entry adds its 0 at ``spread`` (its flat index) folded into ``acc``:
    empty slots sit at position 0, so their own keys would pile up in a
    few bins and queue their atomics on a few addresses."""
    keys = torch.where(valid, keys, spread % acc.numel())
    acc.index_add_(0, keys.reshape(-1), valid.reshape(-1).to(acc.dtype))


def angle_histograms(nbr_pos, nbr_sp, center_pos, center_sp, cell, inv_cell,
                     n_species: int, dtheta: float, bins: int,
                     by_cn: bool = False, out=None):
    """concrete f32[S, S, C, bins] and center_any f32[S, C, bins] from a
    K-slot table: every unordered slot pair (k < l) of every center.

    C = 1, or K + 1 with ``by_cn``: a concrete angle's key then carries
    the center's count of outer-species neighbours, a center-any angle's
    the center's neighbour count (both capped at K, exact when the table
    did not overflow). ``out`` = (concrete, center_any), contiguous
    float64 tensors of those shapes: the counts are added into them and
    they are returned."""
    dev = nbr_pos.device
    m, k_cap = nbr_sp.shape
    kk, ll = torch.triu_indices(k_cap, k_cap, 1, device=dev)
    n_pairs = kk.shape[0]
    cn_slots = k_cap + 1 if by_cn else 1
    # divisor as a device tensor: CUDA divides by a host scalar as a
    # multiply by its reciprocal
    dth = torch.full((), dtheta, dtype=torch.float32, device=dev)
    if out is None:
        conc = torch.zeros(n_species * n_species * cn_slots * bins,
                           dtype=torch.float64, device=dev)
        any_ = torch.zeros(n_species * cn_slots * bins, dtype=torch.float64,
                           device=dev)
    else:
        conc, any_ = (o.view(-1) for o in out)
    iota_s = torch.arange(n_species, device=dev)
    step = max(1, _ANGLE_CELLS // max(n_pairs, 1))
    for r0 in range(0, m, step):
        r1 = min(r0 + step, m)
        sj = nbr_sp[r0:r1].long()
        si = center_sp[r0:r1].long()
        vec = min_image_delta(
            nbr_pos[r0:r1] - center_pos[r0:r1, None, :], cell, inv_cell)
        norm = sqrt_rn(squared_norm(vec))
        unit = vec / torch.clamp(norm, min=1e-12)[..., None]
        uk, ul = unit[:, kk], unit[:, ll]  # [R, T, 3]
        sk, sl = sj[:, kk], sj[:, ll]
        cosang = (uk[..., 0] * ul[..., 0] + uk[..., 1] * ul[..., 1]
                  + uk[..., 2] * ul[..., 2])
        theta = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
        tbin = torch.clamp(torch.floor(theta / dth).long(), max=bins - 1)
        pair_valid = (sk >= 0) & (sl >= 0) & (si >= 0)[:, None]
        same = pair_valid & (sk == sl)
        a_sp = si.clamp(min=0)[:, None]
        b_sp = sk.clamp(min=0)
        if by_cn:
            # per-(center, b) neighbour counts [R, S], and each center's
            # neighbour count
            cn_b = (sj[:, :, None] == iota_s).sum(dim=1)
            cn_of_pair = torch.gather(cn_b, 1, b_sp)
            cn_all = (sj >= 0).sum(dim=1)[:, None]
        else:
            cn_of_pair = cn_all = 0
        key_c = ((a_sp * n_species + b_sp) * cn_slots + cn_of_pair) * bins \
            + tbin
        key_a = (a_sp * cn_slots + cn_all) * bins + tbin
        spread = torch.arange((r1 - r0) * n_pairs, device=dev).view(
            r1 - r0, n_pairs)
        _accumulate(conc, key_c, same, spread)
        _accumulate(any_, key_a, pair_valid, spread)
    if out is not None:
        return out
    return (conc.to(torch.float32).reshape(n_species, n_species, cn_slots,
                                           bins),
            any_.to(torch.float32).reshape(n_species, cn_slots, bins))


def select_spec_counts(concrete, center_any, spec):
    """Counts [cn, theta] for one (center, outer) spec; -1 = wildcard."""
    a, b = spec
    if a >= 0 and b >= 0:
        return concrete[a, b]
    if a >= 0 and b < 0:
        return center_any[a]
    return center_any.sum(axis=0)


def trajectory_bad_counts(positions, cells, species_idx, cutoff_matrix,
                          n_species: int, dtheta: float, bins: int,
                          max_neighbors: int = 24, chunk: int = 256,
                          by_cn: bool = False, window: int = None, slab=None,
                          inv_cells=None):
    """Angle histograms summed over frames, in float64 on the device.
    positions [F, N, 3], cells [F, 3, 3]. Returns (concrete f64[S, S, C,
    bins], center_any f64[S, C, bins], overflow bool[]: some frame's
    table overflowed K or missed its window, and its histograms are
    incomplete)."""
    if inv_cells is None:
        inv_cells = inverse_cell(cells)
    dev = positions.device
    cn_slots = max_neighbors + 1 if by_cn else 1
    conc = torch.zeros((n_species, n_species, cn_slots, bins),
                       dtype=torch.float64, device=dev)
    any_ = torch.zeros((n_species, cn_slots, bins), dtype=torch.float64,
                       device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for f in range(positions.shape[0]):
        _, _, flag = frame_bad_counts(
            positions[f], cells[f], species_idx, cutoff_matrix, n_species,
            dtheta, bins, max_neighbors, chunk, window=window, slab=slab,
            inv_cell=inv_cells[f], by_cn=by_cn, out=(conc, any_),
        )
        overflow |= flag
    return conc, any_, overflow
