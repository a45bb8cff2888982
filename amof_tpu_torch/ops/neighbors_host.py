"""
Host (numpy) periodic neighbor search.

Exact image-enumerating pair search used by the API-parity paths and the
coordination-search code. Replaces three redundant engines of the
reference at once (SURVEY.md §2): ``ase.neighborlist.neighbor_list``
(amof/atom.py:82), pymatgen ``Structure.get_all_neighbors``
(amof/coordination/core.py:62) and ``get_neighbor_list``
(amof/coordination/core.py:181).

The heavy per-frame analyses do NOT go through this module — they use the
fused on-device pair engine in ``amof_tpu_torch.ops.pair_engine``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from amof_tpu_torch.core import cellmath


def _image_shifts(cell: np.ndarray, cutoff: float, pbc: bool) -> np.ndarray:
    """Integer lattice shifts whose image cells can contain neighbors
    within ``cutoff``."""
    if not pbc or cellmath.volume(cell) == 0:
        return np.zeros((1, 3), dtype=np.int64)
    widths = cellmath.min_widths(cell)
    nmax = np.ceil(cutoff / widths).astype(np.int64)
    ranges = [np.arange(-n, n + 1) for n in nmax]
    grid = np.meshgrid(*ranges, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=1)


def neighbor_pairs(
    positions: np.ndarray,
    cell: np.ndarray,
    pbc: bool,
    cutoff,
    species: np.ndarray = None,
    chunk: int = 512,
    _force: str = None,  # tests: "legacy" / "celllist" override dispatch
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All ordered pairs (i, j) with d_ij < cutoff, periodic images included.

    Args:
        positions: [N, 3] cartesian.
        cell: [3, 3] lattice (row vectors).
        pbc: periodic or not.
        cutoff: float (global), or [N_species_max, N_species_max] matrix
            indexed by the values in ``species`` (pairwise cutoffs; 0
            disables a pair — the RINGS-template convention,
            amof/ring/core.py:236-240).
        species: [N] integer species labels (required for matrix cutoff).
        chunk: i-axis blocking to bound memory.

    Returns:
        (i_idx, j_idx, distances, shifts) — each pair appears in both
        orders, matching ase.neighborlist.neighbor_list('ij...') output.
        shifts[k] is the integer image offset applied to atom j.

    Large periodic systems route through an O(N) fractional cell-list
    (this search was 95% of building-unit reduction time at 10k atoms);
    small systems keep the image-enumerating path, whose pair ORDER the
    deterministic golden tests pin down.
    """
    positions = np.asarray(positions, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    n = len(positions)

    if (
        pbc and cellmath.volume(cell) > 0 and _force != "legacy"
        and (n >= 1500 or _force == "celllist")
    ):
        cmax = float(np.asarray(cutoff, dtype=np.float64).max())
        nbins = np.floor(cellmath.min_widths(cell) / max(cmax, 1e-9))
        nbins = np.minimum(nbins, 64).astype(np.int64)
        if (nbins >= 3).all():
            return _neighbor_pairs_celllist(
                positions, cell, cutoff, species, nbins
            )

    cutoff = np.asarray(cutoff, dtype=np.float64)
    if cutoff.ndim == 2:
        if species is None:
            raise ValueError("species required for per-pair cutoff matrix")
        species = np.asarray(species)
        pair_cutoff_full = cutoff[np.ix_(species, species)]  # [N, N]
        max_cutoff = float(cutoff.max())
    else:
        pair_cutoff_full = None
        max_cutoff = float(cutoff)

    shifts = _image_shifts(cell, max_cutoff, pbc)
    shift_cart = shifts @ cell  # [S, 3]

    out_i, out_j, out_d, out_s = [], [], [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        pi = positions[start:stop]  # [C, 3]
        if pair_cutoff_full is not None:
            cmat = pair_cutoff_full[start:stop]  # [C, N]
        for s_idx, sc in enumerate(shift_cart):
            delta = positions[None, :, :] + sc - pi[:, None, :]  # [C, N, 3]
            d = np.sqrt(np.sum(delta * delta, axis=-1))  # [C, N]
            if pair_cutoff_full is not None:
                mask = d < cmat
            else:
                mask = d < max_cutoff
            if np.all(shifts[s_idx] == 0):
                ii = np.arange(start, stop)
                mask[ii - start, ii] = False  # exclude self at zero shift
            ci, cj = np.nonzero(mask)
            if len(ci):
                out_i.append(ci + start)
                out_j.append(cj)
                out_d.append(d[ci, cj])
                out_s.append(np.broadcast_to(shifts[s_idx], (len(ci), 3)))

    if not out_i:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy(), np.empty(0), np.empty((0, 3), dtype=np.int64)
    return (
        np.concatenate(out_i),
        np.concatenate(out_j),
        np.concatenate(out_d),
        np.concatenate(out_s),
    )


def _neighbor_pairs_celllist(positions, cell, cutoff, species, nbins):
    """Cell-list neighbor search: O(N * density * cutoff^3).

    Atoms are binned on a fractional grid whose bins are at least the
    max cutoff wide along every axis, so every in-range pair sits in
    adjacent (wrapped) bins. Returned shifts reproduce the legacy
    semantics: |p_j + S @ cell - p_i| = d for the RAW input positions.
    """
    n = len(positions)
    inv_cell = np.linalg.inv(cell)
    frac_raw = positions @ inv_cell
    base = np.floor(frac_raw).astype(np.int64)  # per-atom home-cell wrap
    frac = frac_raw - base  # in [0, 1)

    cutoff = np.asarray(cutoff, dtype=np.float64)
    if cutoff.ndim == 2:
        if species is None:
            raise ValueError("species required for per-pair cutoff matrix")
        species = np.asarray(species)
    bx, by, bz = (int(v) for v in nbins)
    b3 = np.minimum((frac * nbins).astype(np.int64), nbins - 1)  # [N, 3]
    bin_id = (b3[:, 0] * by + b3[:, 1]) * bz + b3[:, 2]
    n_bins = bx * by * bz

    order = np.argsort(bin_id, kind="stable")
    sorted_bins = bin_id[order]
    starts = np.searchsorted(sorted_bins, np.arange(n_bins))
    ends = np.searchsorted(sorted_bins, np.arange(n_bins), side="right")

    offs = np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)

    out_i, out_j, out_d, out_s = [], [], [], []
    for o in offs:
        nb3 = b3 + o  # [N, 3]
        wrap = np.zeros_like(nb3)
        for k, g in enumerate((bx, by, bz)):
            wrap[:, k] = np.floor_divide(nb3[:, k], g)
        nb3_w = nb3 - wrap * np.array([bx, by, bz])
        nb_id = (nb3_w[:, 0] * by + nb3_w[:, 1]) * bz + nb3_w[:, 2]
        s = starts[nb_id]
        e = ends[nb_id]
        cnt = e - s
        total = int(cnt.sum())
        if total == 0:
            continue
        ii = np.repeat(np.arange(n), cnt)
        idx = (
            np.arange(total)
            - np.repeat(np.cumsum(cnt) - cnt, cnt)
            + np.repeat(s, cnt)
        )
        jj = order[idx]
        # image shift of j relative to the WRAPPED frames, then adjust
        # back to raw-position semantics: p_j + S@cell - p_i with
        # S = wrap_bins + base_i - base_j
        w_pair = np.repeat(wrap, cnt, axis=0)
        delta = (
            frac[jj] + w_pair - frac[ii]
        ) @ cell
        d = np.sqrt(np.sum(delta * delta, axis=-1))
        if cutoff.ndim == 2:
            mask = d < cutoff[species[ii], species[jj]]
        else:
            mask = d < float(cutoff)
        mask &= ~((ii == jj) & (w_pair == 0).all(axis=1))  # self at zero image
        if not mask.any():
            continue
        out_i.append(ii[mask])
        out_j.append(jj[mask])
        out_d.append(d[mask])
        out_s.append(w_pair[mask] + base[ii[mask]] - base[jj[mask]])

    if not out_i:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.copy(), np.empty(0), np.empty((0, 3), dtype=np.int64)
    return (
        np.concatenate(out_i),
        np.concatenate(out_j),
        np.concatenate(out_d),
        np.concatenate(out_s),
    )


def cutoff_dict_to_matrix(
    cutoff_dict: Dict[tuple, float], max_z: int = 119
) -> np.ndarray:
    """Dense symmetric cutoff matrix indexed by atomic number.

    ``cutoff_dict`` keys are (z1, z2) tuples (any order), values cutoffs in
    Å — the format produced by ``amof_tpu_torch.atom.format_cutoff``.
    """
    mat = np.zeros((max_z, max_z))
    for (a, b), c in cutoff_dict.items():
        mat[a, b] = c
        mat[b, a] = c
    return mat
