"""
Bonded-graph stages on the caller's device: the device half of the
ring-statistics engine (the combinatorial enumeration runs in C++ on the
host on these distance matrices; see amof_tpu_torch/native).

Counterpart of ``amof_tpu/ops/graph_kernel.py``, whose all-pairs BFS is an
XLA ``dot_general`` in a ``fori_loop`` (no Pallas kernel). Here it is a
``torch.matmul`` per BFS level, on whatever device the adjacency lies on.
The reach and adjacency matrices hold only 0 and 1 and a product entry is
at most N (< 2^24), so float32 accumulation is exact, and so is TF32
(whose products of 0 and 1 are exact too). Distances stay int32 on the
device; the caller converts to uint16 after the copy to the host
(``to_host_uint16``): ``torch.uint16`` has few CUDA ops.
"""

from __future__ import annotations

import numpy as np
import torch

from amof_tpu_torch.ops.pair_engine import min_image_delta, squared_norm

UNREACHED = 0xFFFF


def bond_adjacency(positions, cell, species_idx, cutoff_matrix):
    """Boolean adjacency: d_ij < cutoff(s_i, s_j), minimum image.

    Full [N, N] — intended for the (small) graphs ring analysis runs on.
    Padding atoms (species -1) have no bonds. Takes float32 tensors (int
    for ``species_idx``) on one device and returns a bool tensor there.
    """
    n = positions.shape[0]
    inv_cell = torch.linalg.inv(cell)
    delta = positions[None, :, :] - positions[:, None, :]
    delta = min_image_delta(delta, cell, inv_cell)
    d2 = squared_norm(delta)
    sp = species_idx.clamp(min=0).long()
    cut = cutoff_matrix[sp[:, None], sp[None, :]]
    eye = torch.eye(n, dtype=torch.bool, device=positions.device)
    return (
        (~eye)
        & (species_idx[:, None] >= 0)
        & (species_idx[None, :] >= 0)
        & (d2 < cut * cut)
    )


def bfs_distances(adj, max_depth: int):
    """All-pairs shortest-path distances up to max_depth.

    Frontier expansion as float32 products: reach_{k+1} = reach_k @ adj,
    ``max_depth - 1`` of them, as ``amof_tpu``'s ``fori_loop(2,
    max_depth + 1)``. Returns int32 [N, N] on ``adj``'s device, with
    UNREACHED beyond max_depth.
    """
    n = adj.shape[0]
    adj = adj.to(torch.bool)
    adj_f = adj.to(torch.float32)
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    dist = torch.where(
        eye, 0, torch.where(adj, 1, UNREACHED)
    ).to(torch.int32)
    reach = eye | adj
    for k in range(2, max_depth + 1):
        new_reach = torch.matmul(reach.to(torch.float32), adj_f) > 0
        dist = torch.where(new_reach & ~reach, k, dist)
        reach = new_reach | reach
    return dist


def to_host_uint16(dist) -> np.ndarray:
    """uint16 numpy copy of a ``bfs_distances`` result (values fit: at
    most max_depth or UNREACHED)."""
    return dist.cpu().numpy().astype(np.uint16)
