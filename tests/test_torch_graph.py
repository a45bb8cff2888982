"""The port's graph stage (``amof_tpu_torch.ops.graph_kernel``) against
``amof_tpu.ops.graph_kernel`` on random graphs of at most 200 nodes: BFS
distances and bond adjacency exactly equal. The port runs its torch code
on the CPU here; the card runs the same code (``tests/test_torch_kernels.py``
holds it against a host BFS there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amof_tpu.ops import graph_kernel as jgk
from amof_tpu_torch import native
from amof_tpu_torch.ops import graph_kernel as tgk


def random_graph(n, n_edges, seed):
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), bool)
    for _ in range(n_edges):
        u, v = rng.integers(0, n, 2)
        if u != v:
            adj[u, v] = adj[v, u] = True
    return adj


@pytest.mark.parametrize("n,n_edges,max_depth,seed", [
    (1, 0, 4, 0), (7, 0, 4, 1), (20, 30, 16, 3), (60, 70, 8, 4),
    (120, 150, 32, 5), (200, 260, 12, 6), (200, 1500, 16, 7),
])
def test_bfs_distances_match_amof_tpu(n, n_edges, max_depth, seed):
    adj = random_graph(n, n_edges, seed)
    got = tgk.bfs_distances(torch.from_numpy(adj), max_depth)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    ref = np.asarray(jgk.bfs_distances(jnp.asarray(adj), max_depth))
    host = tgk.to_host_uint16(got)
    assert host.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(host, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_distances_match_a_host_bfs(seed):
    adj = random_graph(90, 100, seed)
    dist = tgk.to_host_uint16(tgk.bfs_distances(torch.from_numpy(adj), 10))
    lists = [list(np.nonzero(row)[0]) for row in adj]
    for s in range(len(adj)):
        host = native._bfs(lists, s)
        host = np.where(host > 10, tgk.UNREACHED, host)
        np.testing.assert_array_equal(dist[s], host)


def test_bfs_distances_take_a_float_adjacency():
    adj = random_graph(30, 40, 9)
    np.testing.assert_array_equal(
        tgk.bfs_distances(torch.from_numpy(adj).float(), 8).numpy(),
        tgk.bfs_distances(torch.from_numpy(adj), 8).numpy())


def adjacency_case(n, seed, triclinic, n_pads=0):
    """Positions on a 1/32 A grid in a cell with a power-of-two diagonal
    (exact on both backends: XLA:CPU contracts multiply-adds into FMAs)."""
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * 16.0
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 4.0, -2.0, 2.0
    frac = np.round(rng.random((n, 3)) * 512) / 512
    pos = (frac @ cell).astype(np.float32)
    species = rng.integers(0, 3, n).astype(np.int32)
    species[rng.permutation(n)[:n_pads]] = -1
    cut = np.array([[2.5, 2.0, 0.0], [2.0, 3.0, 1.5], [0.0, 1.5, 2.25]],
                   np.float32)
    return pos, cell.astype(np.float32), species, cut


@pytest.mark.parametrize("n,seed,triclinic,n_pads", [
    (50, 0, False, 0), (150, 1, False, 7), (200, 2, True, 0),
    (120, 3, True, 11)])
def test_bond_adjacency_matches_amof_tpu(n, seed, triclinic, n_pads):
    pos, cell, species, cut = adjacency_case(n, seed, triclinic, n_pads)
    got = tgk.bond_adjacency(*map(torch.from_numpy,
                                  (pos, cell, species, cut)))
    ref = np.asarray(jgk.bond_adjacency(*map(jnp.asarray,
                                             (pos, cell, species, cut))))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().sum() > 0
    assert not got.numpy()[species < 0].any()
