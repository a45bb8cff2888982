"""
Bond-angle distribution of one frame: neighbour table -> every unordered
pair of a center's neighbour slots -> minimum-image angle -> histograms.

Counterpart of ``amof_tpu/ops/bad_kernel.py`` (XLA code there, not
Pallas, so plain PyTorch here). It emits two species-resolved tensors
from which every B-A-B spec of the reference's enumeration
(amof/bad.py:122-133) is a slice or a sum:

  * concrete[a, b, 0, theta]: angles with center species a and BOTH outer
    atoms of species b — spec (a, b);
  * center_any[a, 0, theta]: ALL angles at centers of species a — spec
    (a, "X"); summing over a gives ("X", "X").

(The size-1 axis is the JAX package's coordination-number axis, kept so
the outputs have its shapes; the fused step never resolves it.)

The table comes from the 2-level slab windows (kernel #3), the 1-level
sorted window (kernel #4) or the full O(N^2) table, in that order of
preference; the returned flag covers capacity overflow and window misses.
"""

from __future__ import annotations

import torch

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
                     inv_cell=None, emit_missed: bool = False):
    """Angle histograms of one frame.

    ``slab`` (a ``slab_table.SlabPlan``) selects the 2-level table;
    otherwise ``window`` selects the 1-level sorted-window table (None,
    or a window too wide for N, uses the full table). Histograms are
    order-invariant, so every table gives the same counts.

    Returns:
        concrete  f32[S, S, 1, bins]
        center_any f32[S, 1, bins]
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
    conc, any_ = angle_histograms(nbr_pos, nbr_sp, center_pos, center_sp,
                                  cell, inv_cell, n_species, dtheta, bins)
    return (conc, any_, flag, *extra)


def angle_histograms(nbr_pos, nbr_sp, center_pos, center_sp, cell, inv_cell,
                     n_species: int, dtheta: float, bins: int):
    """concrete f32[S, S, 1, bins] and center_any f32[S, 1, bins] from a
    K-slot table: every unordered slot pair (k < l) of every center."""
    dev = nbr_pos.device
    m, k_cap = nbr_sp.shape
    kk, ll = torch.triu_indices(k_cap, k_cap, 1, device=dev)
    n_pairs = kk.shape[0]
    # divisor as a device tensor: CUDA divides by a host scalar as a
    # multiply by its reciprocal
    dth = torch.full((), dtheta, dtype=torch.float32, device=dev)
    conc = torch.zeros(n_species * n_species * bins, dtype=torch.float64,
                       device=dev)
    any_ = torch.zeros(n_species * bins, dtype=torch.float64, device=dev)
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
        key_c = (a_sp * n_species + sk.clamp(min=0)) * bins + tbin
        key_a = a_sp * bins + tbin
        conc += torch.bincount(key_c[same], minlength=conc.shape[0])
        any_ += torch.bincount(key_a[pair_valid], minlength=any_.shape[0])
    return (conc.to(torch.float32).reshape(n_species, n_species, 1, bins),
            any_.to(torch.float32).reshape(n_species, 1, bins))


def select_spec_counts(concrete, center_any, spec):
    """Counts [cn, theta] for one (center, outer) spec; -1 = wildcard."""
    a, b = spec
    if a >= 0 and b >= 0:
        return concrete[a, b]
    if a >= 0 and b < 0:
        return center_any[a]
    return center_any.sum(axis=0)
