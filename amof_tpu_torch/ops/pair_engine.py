"""
Pair engine in PyTorch: minimum-image pair passes of one frame.

Counterpart of ``amof_tpu/ops/pair_engine.py``. One frame's atoms are a
padded ``[N, 3]`` float32 tensor with species ``[N]`` (-1 marks padding);
every function runs on the tensors' device.

  * RDF histograms go to the hand-written kernels of
    ``ops/rdf_kernel.py`` (plain PyTorch on CPU tensors);
  * CN counts and the full neighbour table are plain tensor code;
  * the 1-level sorted-window table sorts atoms by fractional x, checks
    window coverage, and compacts through ``ops/neighbor_kernel.py``.

Minimum image is round-based with ``WRAP_EPS = 1e-7``, exact within half
the minimum cell width (the reference's rmax='half_cell' domain). Every
3x3 transform is written as unrolled multiply-adds in the JAX package's
expression order, and each op rounds on its own, so the CUDA kernels
(built without FMA contraction) reproduce these numbers bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WRAP_EPS = 1e-7
HALF_EPS = float(np.float32(0.5 + WRAP_EPS))  # the f32 constant the wrap adds


def _pick_chunk(n: int, target: int = 256) -> int:
    """Largest chunk <= target dividing the padded atom count."""
    return math.gcd(n, target) if n % target else target


def pad_atoms(positions: np.ndarray, species_idx: np.ndarray, multiple: int = 256):
    """Pad the atom axis to a multiple; padding gets species -1."""
    n = positions.shape[-2]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return positions, species_idx
    pos_pad = np.concatenate(
        [positions, np.zeros(positions.shape[:-2] + (n_pad, 3), positions.dtype)],
        axis=-2,
    )
    sp_pad = np.concatenate([species_idx, np.full(n_pad, -1, species_idx.dtype)])
    return pos_pad, sp_pad


def inverse_cell(cell: torch.Tensor) -> torch.Tensor:
    """float32 inverse of one cell [3, 3] or a stack [F, 3, 3].

    Always computed on the CPU and moved to the cell's device, so the
    CPU and CUDA paths (and the kernels and their plain versions) see the
    same bits; on the CPU it matches ``jnp.linalg.inv`` in float32."""
    inv = torch.linalg.inv(cell.detach().to("cpu", torch.float32))
    return inv.contiguous().to(cell.device)  # LAPACK hands back column-major


def matvec3(v, m):
    """Row-vector 3-matrix product v @ m as unrolled multiply-adds.
    ``m`` is [3, 3] or a stack [..., 3, 3] broadcasting against v[..., 0]."""
    return torch.stack(
        [
            v[..., 0] * m[..., 0, k] + v[..., 1] * m[..., 1, k]
            + v[..., 2] * m[..., 2, k]
            for k in range(3)
        ],
        dim=-1,
    )


def _wrap(frac):
    return frac - torch.floor(frac + HALF_EPS)


def min_image_delta(delta, cell, inv_cell):
    """Round-based minimum image. delta [..., 3]."""
    return matvec3(_wrap(matvec3(delta, inv_cell)), cell)


def sqrt_rn(x):
    """Correctly rounded float32 sqrt on every device, as the kernels'
    IEEE ``sqrtf``: PyTorch's vectorized CPU sqrt is not (measured: 0.7%
    of random float32 inputs off by one ulp on an AVX-512 host). The
    float64 root rounded once to float32 is exact, because float64 has
    more than twice float32's precision."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def squared_norm(v):
    """|v|^2 over the last axis as (x*x + y*y) + z*z."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _within_cutoff(d2, si, sj, cut2):
    """bool[..., I, J]: d2 < cut2[s_i, s_j]; false wherever either
    species is -1 (a zero cutoff disables a pair)."""
    thr = cut2[si.clamp(min=0)[:, None], sj.clamp(min=0)[None, :]]
    return (d2 < thr) & (si >= 0)[:, None] & (sj >= 0)[None, :]


def _rows(n: int, chunk: int):
    for i0 in range(0, n, chunk):
        yield i0, min(i0 + chunk, n)


# --------------------------------------------------------------------------
# RDF: species-pair-resolved distance histogram
# --------------------------------------------------------------------------

def frame_rdf_counts(positions, cell, species_idx, dr: float, n_species: int,
                     bins: int, blocked: bool = False, ortho: bool = False,
                     inv_cell=None):
    """Distance histogram of one frame: float32 [S, S, bins].

    counts[a, b, k] = #{ordered pairs (i in a, j in b), i != j,
    k*dr <= d_ij < (k+1)*dr}. ``blocked`` selects the species-blocked
    kernel (positions in ``rdf_kernel.species_block_layout`` order);
    ``ortho`` certifies a diagonal cell (the kernels drop the cross
    terms, bit-equal to the full transform)."""
    from amof_tpu_torch.ops import rdf_kernel

    fn = rdf_kernel.rdf_counts_blocked if blocked else rdf_kernel.rdf_counts
    return fn(positions, cell, species_idx, dr, n_species, bins,
              ortho=ortho, inv_cell=inv_cell)


def trajectory_rdf_counts(positions, cells, species_idx, dr: float,
                          n_species: int, bins: int, blocked: bool = False,
                          ortho: bool = False, frame_weights=None,
                          inv_cells=None):
    """(Optionally weighted) RDF counts summed over frames: float64
    [S, S, bins]. positions [F, N, 3], cells [F, 3, 3], frame_weights
    [F] (e.g. the volume). Each frame's weighted histogram is formed in
    float32, as in the JAX package, and summed in float64 on the device
    (its place for ``ops/accum.py``'s Neumaier carries)."""
    if inv_cells is None:
        inv_cells = inverse_cell(cells)
    total = torch.zeros((n_species, n_species, bins), dtype=torch.float64,
                        device=positions.device)
    for f in range(positions.shape[0]):
        counts = frame_rdf_counts(positions[f], cells[f], species_idx, dr,
                                  n_species, bins, blocked=blocked,
                                  ortho=ortho, inv_cell=inv_cells[f])
        if frame_weights is not None:
            counts = frame_weights[f] * counts
        total += counts.to(torch.float64)
    return total


# --------------------------------------------------------------------------
# CN: per-species-pair coordination counts under a cutoff matrix
# --------------------------------------------------------------------------

def frame_cn_counts(positions, cell, species_idx, cutoff_matrix,
                    n_species: int, chunk: int = 256, inv_cell=None):
    """float32 [S, S]: out[a, b] = #{(i in a, j in b), i != j :
    d_ij < cutoff[a, b]} (summed over atoms; divide by N_a for the mean
    CN). Unordered pairs i < j, symmetrized."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = positions.shape[0]
    cut2 = cutoff_matrix * cutoff_matrix
    sp = species_idx.long()
    half = torch.zeros(n_species * n_species, dtype=torch.float64,
                       device=positions.device)
    gj = torch.arange(n, device=positions.device)
    for i0, i1 in _rows(n, chunk):
        delta = positions[None, :, :] - positions[i0:i1, None, :]
        d2 = squared_norm(min_image_delta(delta, cell, inv_cell))
        si = sp[i0:i1]
        valid = _within_cutoff(d2, si, sp, cut2)
        valid &= torch.arange(i0, i1, device=gj.device)[:, None] < gj[None, :]
        key = (si[:, None] * n_species + sp[None, :])[valid]
        half += torch.bincount(key, minlength=n_species * n_species)
    half = half.reshape(n_species, n_species)
    return (half + half.T).to(torch.float32)


# --------------------------------------------------------------------------
# Neighbor capture: fixed-capacity neighbor tables
# --------------------------------------------------------------------------

def first_k_slots(valid, k_cap: int):
    """For a bool [R, C] candidate mask, the (row, col, slot) triples of
    the first ``k_cap`` valid columns of every row, in ascending column
    order, plus the per-row count of valid columns."""
    rank = torch.cumsum(valid.to(torch.int32), dim=1)
    keep = valid & (rank <= k_cap)
    rows, cols = keep.nonzero(as_tuple=True)
    return rows, cols, rank[rows, cols] - 1, rank[:, -1]


def frame_neighbor_payload_table(positions, cell, species_idx, cutoff_matrix,
                                 max_neighbors: int = 16, chunk: int = 256,
                                 inv_cell=None):
    """Full O(N^2) neighbour table that emits positions and species
    directly (the last rung of the retry ladder).

    Returns:
        nbr_pos f32[N, K, 3], nbr_sp i32[N, K] (-1 empty),
        nbr_cnt i32[N] (clipped to K), overflow bool[]
    """
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    n = positions.shape[0]
    k = max_neighbors
    dev = positions.device
    cut2 = cutoff_matrix * cutoff_matrix
    sp = species_idx.long()
    nbr_pos = torch.zeros((n, k, 3), dtype=torch.float32, device=dev)
    nbr_sp = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    gj = torch.arange(n, device=dev)
    for i0, i1 in _rows(n, chunk):
        delta = positions[None, :, :] - positions[i0:i1, None, :]
        d2 = squared_norm(min_image_delta(delta, cell, inv_cell))
        valid = _within_cutoff(d2, sp[i0:i1], sp, cut2)
        valid &= torch.arange(i0, i1, device=dev)[:, None] != gj[None, :]
        rows, cols, slots, c = first_k_slots(valid, k)
        nbr_pos[i0 + rows, slots] = positions[cols]
        nbr_sp[i0 + rows, slots] = species_idx[cols].to(torch.int32)
        cnt[i0:i1] = c
    overflow = (cnt > k).any()
    return nbr_pos, nbr_sp, cnt.clamp(max=k), overflow


def sort_by_fractional_x(positions, species_idx, inv_cell):
    """Atoms sorted by wrapped fractional coordinate 0. Pad rows get keys
    spread uniformly through [0, 1), so windows dilute by the pad
    fraction instead of covering a clustered pad block.

    Returns (keys_sorted, pos_sorted, sp_sorted)."""
    n = positions.shape[0]
    frac0 = matvec3(positions, inv_cell)[:, 0]
    frac0 = frac0 - torch.floor(frac0)
    pad_spread = (torch.arange(n, dtype=torch.float32, device=positions.device)
                  + 0.5) / n
    key = torch.where(species_idx >= 0, frac0, pad_spread)
    keys_s, order = torch.sort(key, stable=True)
    return keys_s, positions[order], species_idx[order].to(torch.int32)


def window_missed(keys_s, sp_s, cell, cutoff_matrix, window: int):
    """Sorted-window coverage check (O(N log N), exact): True when some
    real atom has an atom within the worst-case fractional-x reach
    (max cutoff / x-slab width) more than ``window`` sorted positions
    away. Spans run circularly through the pad tail like the windows."""
    n = keys_s.shape[0]
    c = cell.to(torch.float32)
    bxc = torch.linalg.cross(c[1], c[2])
    w0x = torch.abs(torch.linalg.det(c)) / torch.linalg.norm(bxc)
    rxa = torch.max(cutoff_matrix) / w0x + 1e-6
    p_idx = torch.arange(n, device=keys_s.device)
    x_hi = keys_s + rxa
    x_lo = keys_s - rxa
    span_r = torch.where(
        x_hi < 1.0,
        torch.searchsorted(keys_s, x_hi) - 1 - p_idx,
        (n - p_idx) + torch.searchsorted(keys_s, x_hi - 1.0) - 1,
    )
    span_l = torch.where(
        x_lo >= 0.0,
        p_idx - torch.searchsorted(keys_s, x_lo),
        p_idx + (n - torch.searchsorted(keys_s, x_lo + 1.0)),
    )
    return ((sp_s >= 0) & ((span_r > window) | (span_l > window))).any()


def cn_from_table(nbr_sp, center_sp, n_species: int):
    """float32 [S, S] per-species-pair counts read off a compacted table
    (exact whenever no center overflowed K)."""
    cs = center_sp.long()
    ns = nbr_sp.long()
    keep = (cs >= 0)[:, None] & (ns >= 0)
    key = (cs[:, None] * n_species + ns)[keep]
    cn = torch.bincount(key, minlength=n_species * n_species)
    return cn.reshape(n_species, n_species).to(torch.float32)


def frame_neighbor_payload_table_sorted(positions, cell, species_idx,
                                        cutoff_matrix, max_neighbors: int = 16,
                                        chunk: int = 256, window: int = 1024,
                                        emit_cn: bool = False, inv_cell=None,
                                        emit_missed: bool = False):
    """Sorted-window neighbour table (1-level): atoms sorted by wrapped
    fractional x, each chunk of centers tests the circular window of
    ``chunk + 2*window`` sorted atoms around it (kernel #4,
    ``neighbor_kernel.window_table``). Neighbour sets equal the full
    table's whenever the coverage check passes; a miss or a capacity
    overflow raises the returned flag.

    Requires ``chunk + 2*window < N``.

    Returns:
        nbr_pos f32[N, K, 3], nbr_sp i32[N, K] (-1 empty),
        nbr_cnt i32[N] (clipped to K), flag bool[],
        center_pos f32[N, 3], center_sp i32[N] [, cn f32[S, S]]
        [, missed bool[] when emit_missed: the coverage check alone]
    """
    from amof_tpu_torch.ops import neighbor_kernel

    n = positions.shape[0]
    if chunk + 2 * window >= n:
        raise ValueError("window too wide for N; use the full table")
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    keys_s, pos_s, sp_s = sort_by_fractional_x(positions, species_idx,
                                               inv_cell)
    missed = window_missed(keys_s, sp_s, cell, cutoff_matrix, window)
    nbr_pos, nbr_sp, cnt = neighbor_kernel.window_table(
        pos_s, sp_s, cell, cutoff_matrix, max_neighbors, chunk, window,
        inv_cell=inv_cell,
    )
    flag = missed | (cnt > max_neighbors).any()
    out = (nbr_pos, nbr_sp, cnt.clamp(max=max_neighbors), flag, pos_s, sp_s)
    if emit_cn:
        out = out + (cn_from_table(nbr_sp, sp_s, cutoff_matrix.shape[0]),)
    if emit_missed:
        out = out + (missed,)
    return out


CN_WINDOW_SLOTS = 32  # table slots per center of the windowed CN pass


def frame_cn_counts_windowed(positions, cell, species_idx, cutoff_matrix,
                             n_species: int, chunk: int = 256,
                             window: int = 1024, inv_cell=None):
    """CN counts from the sorted-window table (kernel #4): O(N*W) instead
    of the O(N^2) ``frame_cn_counts``. Returns (cn f32[S, S], missed
    bool[]). ``missed`` covers the window's coverage check and a center
    with more than ``CN_WINDOW_SLOTS`` neighbours (the table then holds
    too few to count); either way the caller recomputes the frame with
    the full pass, so the counts it keeps are exact."""
    out = frame_neighbor_payload_table_sorted(
        positions, cell, species_idx, cutoff_matrix, CN_WINDOW_SLOTS, chunk,
        window, emit_cn=True, inv_cell=inv_cell)
    return out[6], out[3]
