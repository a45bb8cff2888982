"""
Species-pair minimum-image distance histogram of one frame: the RDF's
pair pass, as a hand-written CUDA kernel with its plain PyTorch version.

Counterpart of ``amof_tpu/ops/pallas_rdf.py``:

  * ``rdf_counts_blocked`` replaces ``pallas_rdf_counts_blocked``
    (kernel #1): atoms in ``species_block_layout`` order, so a 256-atom
    tile holds one species pair and its histogram is ``bins`` ints of
    shared memory (~11 KB at dr 0.01 on a 55 A box);
  * ``rdf_counts`` replaces ``pallas_rdf_counts`` (kernel #2): any atom
    order, the whole ``S*S*bins`` histogram in shared memory when it fits
    (opt-in above 48 KB), else atomics straight to device memory.

Both launch ``csrc/rdf_hist.cu`` (see its header for the design and what
bounds it) for CUDA tensors and run the plain version for CPU tensors;
there is no fallback between the two. The TPU kernel's one-hot MXU
contraction, quadrant packing and VMEM key scratch have no counterpart:
a shared-memory atomic is the natural histogram on this card.

Counts are integers and equal the plain version's bit for bit: same
expression order, no FMA contraction, IEEE sqrt, ``inv_dr = f32(1/dr)``.
"""

from __future__ import annotations

import numpy as np
import torch

from amof_tpu_torch.ops.pair_engine import HALF_EPS, inverse_cell, sqrt_rn

# launches of each wrapper's CUDA kernel (CPU calls do not count)
LAUNCHES = {"rdf_counts_blocked": 0, "rdf_counts": 0}

MODE_BLOCKED, MODE_SMEM_ALL, MODE_GLOBAL = 0, 1, 2
SMEM_LIMIT = 220 * 1024  # dynamic shared memory one block may opt into
TILE = 256  # atoms per tile side in csrc/rdf_hist.cu


# --------------------------------------------------------------------------
# Species-blocked layout (host side)
# --------------------------------------------------------------------------

def species_block_layout(species_idx, block: int = 1024,
                         total_multiple: int = 256):
    """Host-side re-layout: group atoms by species, pad each group to a
    multiple of ``block`` (pad species -1), pad the total to
    ``total_multiple``. Histograms are permutation-invariant, so every
    kernel downstream accepts the layout unchanged.

    Returns (perm, padded_species) where ``perm`` indexes the original
    atom axis (apply with np.take(..., axis=-2)) and ``padded_species``
    marks pads with -1; real atoms appear in perm order.
    """
    species_idx = np.asarray(species_idx)
    order = np.argsort(species_idx, kind="stable")
    order = order[species_idx[order] >= 0]  # existing pads re-created
    uniq = np.unique(species_idx[species_idx >= 0])
    perm_parts, sp_parts = [], []
    for s in uniq:
        grp = order[species_idx[order] == s]
        pad = (-len(grp)) % block
        perm_parts.append(grp)
        sp_parts.append(np.full(len(grp), s, np.int32))
        if pad:
            perm_parts.append(np.full(pad, -1, np.int64))
            sp_parts.append(np.full(pad, -1, np.int32))
    perm = np.concatenate(perm_parts)
    sp = np.concatenate(sp_parts)
    tail = (-len(sp)) % max(total_multiple, block)
    if tail:
        perm = np.concatenate([perm, np.full(tail, -1, np.int64)])
        sp = np.concatenate([sp, np.full(tail, -1, np.int32)])
    return perm, sp


def apply_atom_layout(positions, perm):
    """Gather positions [..., N, 3] into layout order; pads (-1) get 0."""
    safe = np.maximum(perm, 0)
    out = np.take(positions, safe, axis=-2)
    out[..., perm < 0, :] = 0.0
    return np.ascontiguousarray(out)


# --------------------------------------------------------------------------
# Plain PyTorch version (the kernel's oracle; runs every CPU call)
# --------------------------------------------------------------------------

def _bins_plain(xi, xj, cell, inv, inv_dr: float, ortho: bool):
    """floor(d * inv_dr) for every (i, j) of the [I, 3] x [J, 3] blocks,
    in the kernel's expression order."""
    dx = xj[None, :, 0] - xi[:, None, 0]
    dy = xj[None, :, 1] - xi[:, None, 1]
    dz = xj[None, :, 2] - xi[:, None, 2]
    if ortho:
        fx, fy, fz = dx * inv[0, 0], dy * inv[1, 1], dz * inv[2, 2]
    else:
        fx = dx * inv[0, 0] + dy * inv[1, 0] + dz * inv[2, 0]
        fy = dx * inv[0, 1] + dy * inv[1, 1] + dz * inv[2, 1]
        fz = dx * inv[0, 2] + dy * inv[1, 2] + dz * inv[2, 2]
    fx = fx - torch.floor(fx + HALF_EPS)
    fy = fy - torch.floor(fy + HALF_EPS)
    fz = fz - torch.floor(fz + HALF_EPS)
    if ortho:
        wx, wy, wz = fx * cell[0, 0], fy * cell[1, 1], fz * cell[2, 2]
    else:
        wx = fx * cell[0, 0] + fy * cell[1, 0] + fz * cell[2, 0]
        wy = fx * cell[0, 1] + fy * cell[1, 1] + fz * cell[2, 1]
        wz = fx * cell[0, 2] + fy * cell[1, 2] + fz * cell[2, 2]
    d = sqrt_rn(wx * wx + wy * wy + wz * wz)
    return torch.floor(d * inv_dr).to(torch.int64)


def rdf_half_plain(positions, species_idx, cell, inv_cell, dr: float,
                   n_species: int, bins: int, ortho: bool = False,
                   chunk: int = 256):
    """int64 [S*S*bins]: counts of unordered pairs i < j keyed
    (s_i * S + s_j) * bins + b — what the kernel accumulates."""
    n = positions.shape[0]
    total = n_species * n_species * bins
    inv_dr = float(np.float32(1.0 / dr))
    sp = species_idx.long()
    half = torch.zeros(total, dtype=torch.int64, device=positions.device)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        si, sj = sp[i0:i1], sp[i0:]
        b = _bins_plain(positions[i0:i1], positions[i0:], cell, inv_cell,
                        inv_dr, ortho)
        gi = torch.arange(i0, i1, device=b.device)[:, None]
        gj = torch.arange(i0, n, device=b.device)[None, :]
        valid = (gi < gj) & (si >= 0)[:, None] & (sj >= 0)[None, :] \
            & (b < bins)
        key = (si[:, None] * n_species + sj[None, :]) * bins + b
        half += torch.bincount(key[valid], minlength=total)
    return half


def _symmetrize(half, n_species: int, bins: int):
    half = half.to(torch.float32).reshape(n_species, n_species, bins)
    return half + half.transpose(0, 1)


def rdf_counts_plain(positions, cell, species_idx, dr: float, n_species: int,
                     bins: int, ortho: bool = False, inv_cell=None):
    """Plain PyTorch version of both wrappers (layout-agnostic)."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    half = rdf_half_plain(positions, species_idx, cell, inv_cell, dr,
                          n_species, bins, ortho)
    return _symmetrize(half, n_species, bins)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

def _check_inputs(positions, cell, species_idx, inv_cell):
    dev = positions.device
    n = positions.shape[0]
    if positions.dtype != torch.float32 or positions.shape != (n, 3):
        raise ValueError("positions must be float32 [N, 3]")
    if species_idx.dtype != torch.int32 or species_idx.shape != (n,):
        raise ValueError("species_idx must be int32 [N]")
    for name, t in (("cell", cell), ("inv_cell", inv_cell)):
        if t.dtype != torch.float32 or t.shape != (3, 3):
            raise ValueError(f"{name} must be float32 [3, 3]")
    for t in (positions, species_idx, cell, inv_cell):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(name, mode, positions, cell, species_idx, dr, n_species, bins,
            ortho, inv_cell):
    from amof_tpu_torch import _build

    _check_inputs(positions, cell, species_idx, inv_cell)
    out = torch.zeros(n_species * n_species * bins, dtype=torch.int32,
                      device=positions.device)
    err = _build.library().rdf_hist_launch(
        positions.data_ptr(), species_idx.data_ptr(), cell.data_ptr(),
        inv_cell.data_ptr(), positions.shape[0], n_species, bins,
        float(np.float32(1.0 / dr)), mode, int(bool(ortho)),
        out.data_ptr(), _build.stream_ptr(positions.device),
    )
    _build.check(err, name)
    LAUNCHES[name] += 1
    return _symmetrize(out, n_species, bins)


def rdf_counts_blocked(positions, cell, species_idx, dr: float,
                       n_species: int, bins: int, ortho: bool = False,
                       inv_cell=None):
    """Kernel #1: float32 [S, S, bins] ordered-pair histogram of one frame
    in ``species_block_layout`` order (block a multiple of 256 for full
    speed; any order gives the same counts)."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if positions.device.type == "cpu":
        return rdf_counts_plain(positions, cell, species_idx, dr, n_species,
                                bins, ortho, inv_cell)
    mode = MODE_BLOCKED if bins * 4 <= SMEM_LIMIT else MODE_GLOBAL
    return _launch("rdf_counts_blocked", mode, positions, cell, species_idx,
                   dr, n_species, bins, ortho, inv_cell)


def rdf_counts(positions, cell, species_idx, dr: float, n_species: int,
               bins: int, ortho: bool = False, inv_cell=None):
    """Kernel #2: float32 [S, S, bins] ordered-pair histogram of one frame
    in any atom order (species -1 marks padding)."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if positions.device.type == "cpu":
        return rdf_counts_plain(positions, cell, species_idx, dr, n_species,
                                bins, ortho, inv_cell)
    fits = n_species * n_species * bins * 4 <= SMEM_LIMIT
    return _launch("rdf_counts", MODE_SMEM_ALL if fits else MODE_GLOBAL,
                   positions, cell, species_idx, dr, n_species, bins, ortho,
                   inv_cell)
