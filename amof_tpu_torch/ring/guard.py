"""
Primitivity-regime guard for periodic ring searches.

The ring engine (native/ringsearch.cpp) runs Franzblau/King searches on
the QUOTIENT graph, using quotient-graph BFS distances for the
shortcut (primitivity) test and for shortest-path enumeration. Quotient
distances never exceed true crystal distances, but they can UNDERSHOOT
them through periodic wrap-around — silently rejecting (or failing to
construct) genuine rings that span the cell. The reference inherits the
same regime from the RINGS binary without checking it
(amof/ring/core.py:37-49 states the ring definitions being
approximated); here the regime is certified per frame, with a supercell
fallback and an explicit report_search flag when certification fails.

Certificate (sound): if an n-ring is misclassified, there exist ring
nodes u, v with quotient distance d_q < along-ring distance d_r <=
floor(n/2); the quotient path (net winding w_q) and the ring arc (net
winding w_r) then close into a walk of length d_q + d_r <= n - 1 whose
winding w_q - w_r is NONZERO (were it zero, the quotient path would
lift to a true crystal path between the same images, contradicting
d_true >= d_r > d_q). Hence: **ring sizes n <= w are exact, where w is
the length of the shortest nonzero-winding closed walk** ("winding
girth") of the quotient graph.

``winding_girth_lb`` computes w exactly over walks whose shift
excursion stays within +-2 cells (BFS on the shift-expanded graph,
scipy csgraph), and bounds escaping walks geometrically: reaching a
+-3-cell shift implies a Cartesian excursion >= 2 minimum cell widths
out and back, i.e. length >= 4*W_min/d_max bonds. The returned value is
min(exact-within-clip, geometric floor) — a sound lower bound on w.

Supercell fallback: a 2x2x2 replica's winding girth equals the length
of the shortest closed walk in the ORIGINAL quotient whose winding is
nonzero yet even in every axis — available from the same expanded BFS
with different target states, so certifying the fallback costs no
second search.
"""

from __future__ import annotations

import logging

import numpy as np

from amof_tpu_torch.core.cellmath import cell_widths
from amof_tpu_torch.core.frames import Frame
from amof_tpu_torch.ops.neighbors_host import neighbor_pairs

logger = logging.getLogger(__name__)

_CLIP = 2  # shift-excursion window per axis: [-2, 2]
_S = 2 * _CLIP + 1
_CENTER = (_CLIP * _S + _CLIP) * _S + _CLIP  # linear id of shift (0,0,0)


def supercell_frame(frame, reps=(2, 2, 2)) -> Frame:
    """Replicate ``frame`` ``reps`` times per axis (positions first by
    replica, species tiled, lattice rows scaled)."""
    pos = np.asarray(frame.get_positions(), np.float64)
    cell = np.asarray(frame.get_cell(), np.float64)
    numbers = np.asarray(frame.get_atomic_numbers())
    na, nb, nc = reps
    shifts = np.array(
        [
            i * cell[0] + j * cell[1] + k * cell[2]
            for i in range(na)
            for j in range(nb)
            for k in range(nc)
        ]
    )
    big = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    big_numbers = np.tile(numbers, len(shifts))
    big_cell = cell * np.array(reps, np.float64)[:, None]
    return Frame(big, big_numbers, big_cell, pbc=frame.pbc)


def _expanded_graph(i_idx, j_idx, shifts, n_nodes):
    """Sparse adjacency of the shift-expanded graph: states
    (node, clipped shift), edges dropping transitions that leave the
    +-_CLIP window (escapers are bounded geometrically by the caller).
    """
    from scipy.sparse import coo_matrix

    ax = np.arange(_S)
    base = np.stack(
        np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1
    ).reshape(-1, 3)  # [125, 3] current shift index (offset by _CLIP)
    new = base[None, :, :] + shifts[:, None, :]  # [E, 125, 3]
    ok = ((new >= 0) & (new < _S)).all(axis=-1)
    base_lin = (base[:, 0] * _S + base[:, 1]) * _S + base[:, 2]
    new_lin = (new[..., 0] * _S + new[..., 1]) * _S + new[..., 2]
    src = (i_idx[:, None] * (_S**3) + base_lin[None, :])[ok]
    dst = (j_idx[:, None] * (_S**3) + new_lin)[ok]
    n_states = n_nodes * _S**3
    return coo_matrix(
        (np.ones(len(src), np.int8), (src, dst)),
        shape=(n_states, n_states),
    ).tocsr()


def winding_girth_lb(
    i_idx, j_idx, shifts, n_nodes, cap: int, min_width: float,
    d_max: float,
):
    """Sound lower bounds on the winding girth of the quotient graph
    and of its 2x2x2 supercell.

    Returns ``(w_unit, w_super)``; a value of ``cap + 1`` means "no
    offending walk of length <= cap exists" (certified through cap).
    """
    shifts = np.asarray(shifts, np.int64).reshape(-1, 3)
    nz = np.any(shifts != 0, axis=1)
    if n_nodes == 0 or not nz.any():
        return cap + 1, cap + 1  # acyclic in shift space: no winding
    if np.abs(shifts).max() > _CLIP:
        # a single bond spanning >2 cells: the clip construction is
        # invalid; certify nothing (cells this small are far outside
        # the reference's operating regime)
        return 0, 0
    geo = int(np.ceil(4.0 * min_width / max(d_max, 1e-9)))

    graph = _expanded_graph(i_idx, j_idx, shifts, n_nodes)

    # every nonzero-winding closed walk can be rotated to start with a
    # nonzero-shift edge (u -> v, e); its remainder is a path from
    # state (v, e) to (u, s - e + e) = (u, s) for the walk's net
    # winding s. One multi-source BFS serves both certificates — only
    # the accepted target shifts differ.
    wi = np.where(nz)[0]
    shift_lin = (
        (shifts[wi, 0] + _CLIP) * _S + (shifts[wi, 1] + _CLIP)
    ) * _S + (shifts[wi, 2] + _CLIP)
    starts = j_idx[wi] * (_S**3) + shift_lin
    u_nodes = i_idx[wi]
    uniq_starts, inv = np.unique(starts, return_inverse=True)

    sgrid = np.arange(-_CLIP, _CLIP + 1)
    tgrid = np.stack(
        np.meshgrid(sgrid, sgrid, sgrid, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    nonzero = np.any(tgrid != 0, axis=1)
    even = np.all(tgrid % 2 == 0, axis=1)
    unit_targets = np.where(nonzero)[0]  # s != 0
    super_targets = np.where(nonzero & even)[0]  # s != 0, s == 0 mod 2

    from scipy.sparse.csgraph import dijkstra

    w_unit = np.inf
    w_super = np.inf
    chunk = 64  # bound the [chunk, n_states] distance matrix
    for c0 in range(0, len(uniq_starts), chunk):
        idx = uniq_starts[c0:c0 + chunk]
        dist = dijkstra(
            graph, directed=True, unweighted=True, indices=idx,
            limit=float(cap),
        )  # [chunk, n_states]
        rows = np.where((inv >= c0) & (inv < c0 + len(idx)))[0]
        for k in rows:
            row = dist[inv[k] - c0]
            base = u_nodes[k] * (_S**3)
            w_unit = min(w_unit, 1 + row[base + unit_targets].min())
            w_super = min(w_super, 1 + row[base + super_targets].min())
        if w_unit <= 2 and w_super <= 2:
            break  # can't get lower
    w_unit = int(w_unit) if np.isfinite(w_unit) else cap + 1
    w_super = int(w_super) if np.isfinite(w_super) else cap + 1
    return min(w_unit, geo, cap + 1), min(w_super, geo, cap + 1)


def certified_max_ring_sizes(frame, cutoff_matrix, species, cap: int):
    """Per-frame certificate: largest ring sizes for which the
    quotient-graph search is provably exact, in the unit cell and in
    the 2x2x2 supercell.

    Returns (n_exact_unit, n_exact_super).
    """
    i_idx, j_idx, dists, shifts = neighbor_pairs(
        frame.get_positions(), frame.get_cell(), frame.pbc,
        cutoff_matrix, species=species,
    )
    if len(i_idx) == 0:
        return cap + 1, cap + 1
    w = winding_girth_lb(
        i_idx, j_idx, shifts, len(frame), cap,
        min(cell_widths(frame.get_cell())), float(dists.max()),
    )
    return w  # sizes n <= w are exact (misclassification needs a
    #           winding walk of length <= n - 1 < w)
