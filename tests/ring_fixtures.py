"""Ring inputs shared by the CPU tests and ``chip_smoke.py`` (which loads
this file by path): the decorated diamond net, the cell-spanning ring
frame and a scipy oracle of the all-pairs BFS. numpy, scipy and
``amof_tpu_torch`` only: the card machine runs it without jax."""

import numpy as np

RING_CUTOFFS = {"Fr-Zn": 3.8}


def decorated_diamond(reps, n_frames=1, sigma=0.0, seed=0, zn_zn=6.0):
    """The Zn-imidazolate topology at ZIF scale: Zn on the sites of a
    diamond net (Zn-Zn ``zn_zn`` A), a linker node (Fr, the symbol
    ``example_reduced.symbols`` gives Im) at each Zn-Zn midpoint, in
    reps^3 conventional cells (8 reps^3 Zn, 16 reps^3 Fr). Every frame
    adds Gaussian jitter of ``sigma`` A from one generator seeded with
    ``seed``. Returns (positions [n_frames, N, 3] float64, numbers,
    cell). Without jitter the census counts two 12-node rings a Zn."""
    a = 4 * zn_zn / np.sqrt(3)
    fcc = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    cells = np.array([[i, j, k] for i in range(reps) for j in range(reps)
                      for k in range(reps)], np.float64)
    site_a = (fcc[None] + cells[:, None]).reshape(-1, 3) * a
    site_b = site_a + a / 4
    dirs = np.array([[-1, -1, -1], [-1, 1, 1], [1, -1, 1], [1, 1, -1]])
    links = (site_b[:, None] + dirs[None] * a / 8).reshape(-1, 3)
    pos = np.concatenate([site_a, site_b, links])
    rng = np.random.default_rng(seed)
    frames = np.stack([pos + rng.normal(0, sigma, pos.shape) if sigma
                       else pos for _ in range(n_frames)])
    numbers = np.array([30] * (2 * len(site_a)) + [87] * len(links))
    return frames, numbers, np.eye(3) * a * reps


def net_frames(reps, n_frames=1, sigma=0.1, seed=0):
    """``decorated_diamond`` as the port's Frames."""
    from amof_tpu_torch.core.frames import Frame

    pos, numbers, cell = decorated_diamond(reps, n_frames, sigma, seed)
    return [Frame(p, numbers, cell) for p in pos]


def spanning_ring_frame():
    """``tests/test_ring.py``'s fixture: an 8-ring crossing the x boundary
    plus a chord bond that exists only through a periodic image, so the
    unit cell's quotient distances reject the ring and the 2x2x2
    supercell census must engage. Returns (positions, numbers, cell,
    cutoffs)."""
    pos = np.array([
        [0.5, 10.0, 10.0], [2.5, 10.0, 10.0], [4.5, 10.0, 10.0],
        [6.5, 10.0, 10.0], [0.5, 12.2, 10.0], [6.5, 12.2, 10.0],
        [4.5, 12.2, 10.0], [2.5, 12.2, 10.0],
    ])
    cutoffs = {"H-He": 2.1, "He-Li": 2.1, "Li-Be": 2.1, "Be-B": 3.0,
               "B-C": 2.1, "C-N": 2.1, "N-O": 2.1, "O-H": 3.0, "H-Be": 2.1}
    return pos, np.arange(1, 9), np.diag([8.0, 20.0, 20.0]), cutoffs


def scipy_bfs(adj, depth, chunk=256):
    """Host oracle of ``bfs_distances``: scipy's unweighted shortest
    paths in chunks of sources, capped at ``depth`` as the device BFS
    caps it (UNREACHED beyond)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from amof_tpu_torch.ops.graph_kernel import UNREACHED

    graph = csr_matrix(adj.astype(np.int8))
    out = np.empty(adj.shape, np.uint16)
    for s0 in range(0, len(adj), chunk):
        d = shortest_path(graph, unweighted=True,
                          indices=np.arange(s0, min(s0 + chunk, len(adj))))
        out[s0:s0 + chunk] = np.where(d <= depth, d, UNREACHED)
    return out
