"""
Species-pair minimum-image distance histogram of one frame: the RDF's
pair pass, as hand-written CUDA kernels with their plain PyTorch version.

Counterpart of ``amof_tpu/ops/pallas_rdf.py``:

  * ``rdf_counts_blocked`` replaces ``pallas_rdf_counts_blocked``
    (kernel #1): atoms in ``species_block_layout`` order (groups padded to
    a multiple of 256), so a 256-atom tile holds one species pair and its
    histogram is ``bins`` ints of shared memory (~11 KB at dr 0.01 on a
    55 A box). A persistent grid takes (i tile, half j tile) work items
    from a queue (``_queue``), so the SMs finish together. The kernel
    checks that contract once an item (each tile's real atoms are a
    prefix of one species) and then loops over the real prefixes only,
    with no per-pair species or ``j > i`` test off the diagonal; an item
    whose tiles break it takes a general loop, so any order gives the
    same counts. It keeps a pair iff ``d2 < d2_cut(dr, bins)``, which
    holds exactly when the pair's bin is below ``bins`` (see ``d2_cut``),
    and takes the root without ``sqrtf``'s range test. Its bins are exact
    only where that root equals ``sqrtf`` on every float32 it can meet
    (``root_mismatches() == 0``, as on an H100 with the sm_90a build): the
    wrapper runs that check once per device before its first launch and
    raises where it fails;
  * ``rdf_counts`` replaces ``pallas_rdf_counts`` (kernel #2): any atom
    order. It takes #1's items from its own queue, #1's cut and root, and
    counts each unordered species pair under one key (min, max), so its
    histogram is ``S(S+1)/2 * bins`` ints: in shared memory when that fits
    ``SMEM_LIMIT`` (zeroed and merged once a block), else device-memory
    atomics past the cut only. A second kernel of the same launch writes
    the float32 [S, S, bins] result (the symmetrize of the plain version),
    so the wrapper allocates the output alone. The same root check and
    ``dr`` refusal as #1's hold.

Both launch ``csrc/rdf_hist.cu`` (see its header for the design, what
bounds it and why its floors are exact) for CUDA tensors and run the
plain version for CPU tensors; there is no fallback between the two. The
TPU kernel's one-hot MXU contraction, quadrant packing and VMEM key
scratch have no counterpart: a shared-memory atomic is the natural
histogram on this card.

Counts are integers and equal the plain version's bit for bit: same
expression order, no FMA contraction, IEEE sqrt, ``inv_dr = f32(1/dr)``.
Kernel #2's folded key makes its float32 [a, b] entry the float32 of
the sum of the two orders' counts, where the plain version adds the two
float32: equal while every count is below 2^24 (see ``rdf_counts``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.ops.pair_engine import HALF_EPS, inverse_cell, sqrt_rn

MODE_BLOCKED, MODE_SMEM_ALL, MODE_GLOBAL = 0, 1, 2
SMEM_LIMIT = 220 * 1024  # dynamic shared memory one block may opt into
TILE = 256  # atoms per tile side in csrc/rdf_hist.cu


def fold_ints(n_species: int, bins: int) -> int:
    """Ints of kernel #2's histogram: one row of ``bins`` for each
    unordered species pair, padded to a multiple of 4."""
    return -(-(n_species * (n_species + 1) // 2 * bins) // 4) * 4


def smem_mode(n_species: int, bins: int) -> int:
    """Kernel #2's mode: its histogram and S x S key table in shared
    memory when they fit ``SMEM_LIMIT``, else MODE_GLOBAL."""
    fits = 4 * (fold_ints(n_species, bins) + n_species ** 2) <= SMEM_LIMIT
    return MODE_SMEM_ALL if fits else MODE_GLOBAL


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

def d2_plain(xi, xj, cell, inv, ortho: bool):
    """Squared minimum-image distance for every (i, j) of the [I, 3] x
    [J, 3] blocks, in the kernel's expression order."""
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
    return wx * wx + wy * wy + wz * wz


def bin_plain(d2, inv_dr: float):
    """floor(sqrt_rn(d2) * inv_dr) in float32, as int64."""
    return torch.floor(sqrt_rn(d2) * inv_dr).to(torch.int64)


@functools.lru_cache(maxsize=64)
def d2_cut(dr: float, bins: int) -> float:
    """The smallest float32 d2 whose bin ``floor(sqrt_rn(d2) * f32(1/dr))``
    is >= ``bins`` (0.0 when ``bins`` <= 0): kernel #1 keeps a pair iff
    its d2 < d2_cut.

    Exact: the bin is monotone non-decreasing in d2 (a correctly rounded
    root, an RN product by a positive constant and floor all are), so
    ``d2 >= d2_cut`` <=> ``bin >= bins``. Found by bisection over the
    bit patterns of non-negative float32 (ordered like the values), with
    the plain version's own root and float32 product; cached per
    (dr, bins), so a frame pays nothing for it."""
    if bins <= 0:
        return 0.0
    inv_dr = float(np.float32(1.0 / dr))

    def reaches(bits: int) -> bool:
        d2 = torch.tensor([bits], dtype=torch.int32).view(torch.float32)
        return bool(torch.floor(sqrt_rn(d2) * inv_dr)[0] >= bins)

    lo, hi = 0, 0x7F800000  # bin(0) = 0 < bins; bin(+inf) >= bins
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if reaches(mid):
            hi = mid
        else:
            lo = mid
    return float(np.array(hi, np.int32).view(np.float32))


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
        b = bin_plain(d2_plain(positions[i0:i1], positions[i0:], cell,
                               inv_cell, ortho), inv_dr)
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


_QUEUES = {}  # (device index, stream) -> the kernels' work queues


def _queue(device, stream) -> int:
    """The work queues on this device and stream: two int32 for kernel
    #1, then two for kernel #2 (at +8 bytes), zeroed once here and left
    zero by every launch (its last block resets them). One per stream, so
    launches on two streams never share one."""
    key = (device.index, stream)
    buf = _QUEUES.get(key)
    if buf is None:
        buf = _QUEUES[key] = torch.zeros(4, dtype=torch.int32, device=device)
    return buf.data_ptr()


_HISTS = {}  # (device index, stream) -> kernel #2's device histogram


def _device_hist(device, stream, n_species, bins):
    """Kernel #2's device histogram on this device and stream, as
    (pointer, ints): zeroed when it is made and left zero by every launch
    (its fold kernel clears what it reads); grown when a launch needs
    more. One per stream, so launches on two streams never share one."""
    need = fold_ints(n_species, bins)
    key = (device.index, stream)
    buf = _HISTS.get(key)
    if buf is None or buf.numel() < need:
        buf = _HISTS[key] = torch.zeros(need, dtype=torch.int32,
                                        device=device)
    return buf.data_ptr(), buf.numel()


def _launch(name, mode, positions, cell, species_idx, dr, n_species, bins,
            ortho, inv_cell):
    from amof_tpu_torch import _build

    _check_inputs(positions, cell, species_idx, inv_cell)
    inv_dr = float(np.float32(1.0 / dr))
    if inv_dr >= 2.0 ** 50:
        # below d2 = 2^-100 the kernels bin max(d2, 2^-100): bin 0 only
        # while 2^-50 * inv_dr < 1
        raise ValueError(f"{name} needs dr > 2^-50 A")
    dev = positions.device
    _require_exact_root(dev)
    lib = _build.library()
    n = positions.shape[0]
    args = (positions.data_ptr(), species_idx.data_ptr(), cell.data_ptr(),
            inv_cell.data_ptr(), n, n_species, bins, inv_dr,
            d2_cut(dr, bins))
    stream = _build.stream_ptr(positions)
    queue = _queue(dev, stream)
    if mode == MODE_BLOCKED:
        out = torch.zeros(n_species * n_species * bins, dtype=torch.int32,
                          device=dev)
        err = lib.rdf_blocked_launch(*args, int(bool(ortho)), queue,
                                     out.data_ptr(), stream)
    else:
        out = torch.empty((n_species, n_species, bins), dtype=torch.float32,
                          device=dev)
        hist, cap = _device_hist(dev, stream, n_species, bins)
        err = lib.rdf_hist_launch(*args, mode, int(bool(ortho)), queue + 8,
                                  hist, cap, out.data_ptr(), stream)
    _build.check(err, name)
    tracing.count("launch." + name)  # CPU calls do not count
    return _symmetrize(out, n_species, bins) if mode == MODE_BLOCKED else out


def launch_geometry(mode: int, n: int, n_species: int, bins: int,
                    ortho: bool = False) -> dict:
    """What a launch at these shapes gets on the current card: blocks,
    threads a block, dynamic shared bytes, resident blocks per SM,
    registers a thread, work items (the queue's 256 x 128-slot items) and
    waves (blocks over the resident slots of every SM; a persistent grid
    is at most one). ``mode``: MODE_BLOCKED for kernel #1, else kernel
    #2's mode (``smem_mode``)."""
    from amof_tpu_torch import _build

    geo = (ctypes.c_int * 6)()
    _build.check(_build.library().rdf_hist_geometry(
        mode, n, n_species, bins, int(bool(ortho)), geo), "rdf_hist_geometry")
    blocks, threads, smem, per_sm, regs, items = list(geo)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return {"blocks": blocks, "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "registers": regs, "sms": sms,
            "items": items, "waves": blocks / max(per_sm * sms, 1)}


def root_mismatches(device="cuda") -> int:
    """How many float32 x in [2^-100, FLT_MAX] the kernels' root (the fast
    path of the IEEE square root, without its range test) gives unlike
    ``sqrtf``: 0 makes their bins exact. Card only."""
    from amof_tpu_torch import _build

    bad = torch.zeros(1, dtype=torch.int32, device=device)
    _build.check(_build.library().rdf_root_check_launch(
        bad.data_ptr(), _build.stream_ptr(bad)), "rdf_root_check")
    return int(bad.item())


_ROOT_CHECKED = set()  # device indices where root_mismatches() gave 0


def _require_exact_root(device):
    """The kernels' bins are exact only where their root equals ``sqrtf``:
    check that once per device (a few ms, at the first launch of #1 or
    #2) and raise where it does not hold."""
    if device.index in _ROOT_CHECKED:
        return
    bad = root_mismatches(device)
    if bad:
        raise RuntimeError(
            f"rdf kernels: on this card the kernels' root differs from "
            f"sqrtf on {bad} float32 values, so their bins would not be "
            f"exact")
    _ROOT_CHECKED.add(device.index)


def rdf_counts_blocked(positions, cell, species_idx, dr: float,
                       n_species: int, bins: int, ortho: bool = False,
                       inv_cell=None):
    """Kernel #1: float32 [S, S, bins] ordered-pair histogram of one frame
    in ``species_block_layout`` order (block a multiple of 256 for full
    speed; any order gives the same counts). Above ``SMEM_LIMIT`` bytes of
    bins it takes kernel #2's device-memory atomics (MODE_GLOBAL)."""
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
    in any atom order (species -1 marks padding). Equal to the plain
    version bit for bit while every count of an unordered species pair
    and bin is below 2^24 (beyond that the plain version's float32 sum of
    the two orders and the kernel's float32 of their sum may round
    apart); a frame of at most 5793 atoms always is."""
    if inv_cell is None:
        inv_cell = inverse_cell(cell)
    if positions.device.type == "cpu":
        return rdf_counts_plain(positions, cell, species_idx, dr, n_species,
                                bins, ortho, inv_cell)
    return _launch("rdf_counts", smem_mode(n_species, bins), positions, cell,
                   species_idx, dr, n_species, bins, ortho, inv_cell)
