"""
Exact channel identification by displacement vectors (Zeo++ semantics).

Counterpart of ``amof_tpu/pore/winding.py``. A connected void component
is an infinite channel iff some cycle of its quotient graph has a nonzero
net lattice translation; the channel's dimensionality is the rank of the
lattice those translations generate (the reference's ``-chan``, and the
accessible/non-accessible split of ``-sa``/``-vol``).

The open (non-periodic) components come from the flood fill
(``grid_kernel.label_components``: kernel #7 on CUDA tensors). The
quotient graph has one node per open component and one edge per periodic
face adjacency, carrying a unit lattice shift; union-find with integer
displacement potentials finds the inconsistent cycles, whose mismatch
vectors generate each component's winding lattice. That part is host
numpy over the face labels only.

``face_test_is_exact`` certifies the device same-label face test
(``grid_kernel.void_classification_mask``) from one frame's wrap-edge
label pairs, which ``BatchedPore(winding="exact")`` uses.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class _OffsetUnionFind:
    """Union-find whose nodes carry integer displacement potentials:
    ``find(x)`` returns (root, offset of x relative to the root)."""

    def __init__(self):
        self.parent: Dict[int, int] = {}
        self.offset: Dict[int, np.ndarray] = {}

    def add(self, x: int):
        if x not in self.parent:
            self.parent[x] = x
            self.offset[x] = np.zeros(3, np.int64)

    def find(self, x: int) -> Tuple[int, np.ndarray]:
        # iterative find with full path compression
        path = []
        while self.parent[x] != x:
            path.append(x)
            x = self.parent[x]
        root = x
        acc = np.zeros(3, np.int64)
        for y in reversed(path):
            acc = acc + self.offset[y]
            self.parent[y] = root
            self.offset[y] = acc.copy()
        return root, acc if path else np.zeros(3, np.int64)

    def union(self, a: int, b: int, d: np.ndarray):
        """Assert phi(b) - phi(a) = d; returns the mismatch vector if a
        and b were already connected (zero when consistent)."""
        ra, oa = self.find(a)  # oa = phi(a) relative to ra
        rb, ob = self.find(b)
        if ra == rb:
            return (ob - oa) - d
        # attach rb under ra: phi(b) rel ra = ob + offset(rb) = oa + d
        self.parent[rb] = ra
        self.offset[rb] = oa + d - ob
        return None


def _face_union(a: np.ndarray, b: np.ndarray, axis_ids: np.ndarray):
    """Union-find with displacement potentials over the wrap-edge label
    pairs (a = label at the last slice of a face position, b = at the
    first slice, axis_ids = the face's axis). Returns (uf, winding):
    winding maps each final root whose cluster has an inconsistent cycle
    (a channel) to the rank of its winding lattice."""
    uf = _OffsetUnionFind()
    mismatches: Dict[int, List[np.ndarray]] = {}
    for axis in range(3):
        both = (axis_ids == axis) & (a >= 0) & (b >= 0)
        if not both.any():
            continue
        shift = np.zeros(3, np.int64)
        shift[axis] = 1
        # a repeated (a, b) pair has the same mismatch: one of each
        pairs = np.unique(np.stack([a[both], b[both]], axis=1), axis=0)
        for pa, pb in pairs:
            pa, pb = int(pa), int(pb)
            uf.add(pa)
            uf.add(pb)
            mis = uf.union(pa, pb, shift)
            if mis is not None and np.any(mis != 0):
                root, _ = uf.find(pa)
                mismatches.setdefault(root, []).append(mis)

    # re-root the mismatch lists (roots may have merged since)
    by_final_root: Dict[int, List[np.ndarray]] = {}
    for r, vecs in mismatches.items():
        fr, _ = uf.find(r)
        by_final_root.setdefault(fr, []).extend(vecs)

    winding: Dict[int, int] = {}
    for root, vecs in by_final_root.items():
        rank = int(np.linalg.matrix_rank(np.stack(vecs)))
        if rank >= 1:
            winding[root] = rank
    return uf, winding


def _channels(a, b, axis_ids):
    """(channel labels int64 [C], per-channel dimensionalities) of the
    open components that the face pairs join into winding clusters."""
    uf, winding = _face_union(a, b, axis_ids)
    dims = [winding[r] for r in winding]
    labels = [lab for lab in uf.parent if uf.find(lab)[0] in winding]
    return np.array(sorted(labels), dtype=np.int64), dims


def face_test_is_exact(pairs, axis_ids) -> bool:
    """Does the device same-label face test classify this frame exactly?
    ``pairs`` is the frame's i32 [2, n_face] wrap-edge label pairs
    (``grid_kernel.face_label_pairs``).

    The face test seeds channels at face positions with a == b, and the
    periodic flood fill spreads them through exactly the union-find
    clusters. A self-pair is an inconsistent cycle (net shift one lattice
    vector), so every device-accessible cluster truly winds; the only
    possible error is a winding cluster with no self-pair (a multi-wrap
    composite channel). True iff every winding cluster holds a
    self-pair."""
    pairs = np.asarray(pairs)
    a, b = pairs[0], pairs[1]
    uf, winding = _face_union(a, b, np.asarray(axis_ids))
    if not winding:
        return True
    self_m = (a >= 0) & (a == b)
    seeded = {uf.find(int(lab))[0] for lab in np.unique(a[self_m])}
    return set(winding).issubset(seeded)


def channel_analysis(open_labels: np.ndarray):
    """Exact channel analysis of open (non-periodic) component labels
    (i32 [Gx, Gy, Gz], -1 outside the void).

    Returns dict: accessible (bool grid: voxels of winding components),
    n_channels (number of distinct channels), dims (their
    dimensionalities, descending)."""
    from amof_tpu_torch.pore import grid_kernel

    labels = np.asarray(open_labels)
    faces = grid_kernel.face_label_pairs(torch.from_numpy(labels)).numpy()
    chan_labels, dims = _channels(faces[0], faces[1],
                                  grid_kernel.face_axis_ids(labels.shape))
    return {"accessible": np.isin(labels, chan_labels),
            "n_channels": len(dims),
            "dims": sorted(dims, reverse=True)}


def void_classification_exact(mask, return_dims: bool = False):
    """(mask, accessible, pocket) of a bool mask on its device, by the
    general winding test: the open labels come from kernel #7 (CUDA) or
    the plain sweeps (CPU); their face slices go to the host once for the
    union-find, and the channel labels come back for one ``isin`` on the
    device. With ``return_dims`` also the channels' dimensionalities (a
    list, one per channel: ``channel_analysis``'s ``dims``, unsorted)."""
    from amof_tpu_torch.pore import grid_kernel

    mask = mask.bool()
    open_labels = grid_kernel.label_components(mask, periodic=False)
    faces = grid_kernel.face_label_pairs(open_labels).cpu().numpy()
    chan_labels, dims = _channels(faces[0], faces[1],
                                  grid_kernel.face_axis_ids(mask.shape))
    accessible = torch.isin(open_labels, torch.from_numpy(chan_labels).to(
        device=mask.device, dtype=open_labels.dtype))
    if return_dims:
        return mask, accessible, mask & ~accessible, dims
    return mask, accessible, mask & ~accessible
