"""Kernel #3's decomposition (the slab-window K-slot neighbour table), on
its plain twin.

``neighbor_kernel.window_table_slab_compact`` runs the table as the CUDA
kernel does: blocks of ``slab_centers_per_block`` centers of one chunk; a
block whose centers are all fillers writes empty rows and touches no
candidate; otherwise the chunk's columns whose key lies in their run's
range are compacted in column order, staged pass by pass (flushed before a
pass that would overflow the staging), and each live center's slots fill
from the staged columns in order. It must equal the plain version
``window_table_slab_plain`` (every column tested, then masked) bit for
bit: positions, species and counts. Tolerance: exact.

Inputs: the bench glass recipe (Zn(C3N2H3)2 at 0.062 atoms/A^3, bench.py's
cutoffs) through ``slab_table.build_slab_layout`` in cubic and triclinic
cells; hand-edited ``qbounds`` (empty runs, reversed bounds, runs covering
their whole window, overlapping runs); candidate columns in random key
order; all-filler chunks; a chunk with one live center; a crowded center
with more than K neighbours; K = 1, 8, 16 and 1024; a window of 3 x 512
columns all in range, which makes the staging flush; and one case against
``amof_tpu``'s ``pallas_window_table_slab`` in interpret mode.

Mutations of the twin tried, each failing at least one test here: the key
mask dropped (every column of the three runs kept); the runs reordered
(run 1's columns staged before run 0's); self excluded by the center's
column in its chunk instead of by global index; a block with one live
center skipped as if it held none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amof_tpu.ops import pallas_neighbors as jax_nb
from amof_tpu.ops import slab_table as jax_slab
from amof_tpu_torch.ops import neighbor_kernel as nk
from amof_tpu_torch.ops import slab_table

from test_torch_kernels import launches
from test_torch_rdf import grid_case, t

torch.set_num_threads(2)

# bench.py's cutoffs on species (Zn, N, C, H): Zn-N 2.0, C-C 1.75,
# C-N 1.73, C-H 1.3 A
BENCH_CUT = np.zeros((4, 4), np.float32)
for _a, _b, _c in ((0, 1, 2.0), (2, 2, 1.75), (2, 1, 1.73), (2, 3, 1.3)):
    BENCH_CUT[_a, _b] = BENCH_CUT[_b, _a] = _c


def bench_layout(n, seed=0, triclinic=False, crowd=0):
    """The bench glass's first frame at ``n`` atoms through the slab
    layout: (centers, cand, starts, qbounds, cell, cutoff, plan). With
    ``crowd``, that many N atoms are put within 1.0-1.7 A of the first
    Zn."""
    counts = [n // 17, 4 * (n // 17), 6 * (n // 17)]
    counts.append(n - sum(counts))
    sp = np.concatenate([np.full(c, k, np.int32)
                         for k, c in enumerate(counts)])
    box = (n / 0.062) ** (1 / 3)
    rng = np.random.default_rng(seed)
    cell = np.eye(3, dtype=np.float32) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = box / 4, box / 8, -box / 5
    pos = (rng.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    if crowd:
        off = rng.normal(0, 1, (crowd, 3))
        off *= (rng.uniform(1.0, 1.7, crowd)
                / np.linalg.norm(off, axis=1))[:, None]
        pos[counts[0]:counts[0] + crowd] = pos[0] + off
    plan = slab_table.slab_plan(cell, float(BENCH_CUT.max()), n,
                                positions=pos[None], species_idx=sp)
    assert plan is not None
    lay = slab_table.build_slab_layout(t(pos), t(sp), t(cell), plan)
    assert not bool(lay[4])
    return (*lay[:4], t(cell), t(BENCH_CUT), plan)


def live_per_chunk(centers, chunk):
    return (centers[:, 3] >= 0).reshape(-1, chunk).sum(dim=1)


def assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, k, chunk,
                             window):
    args = (centers, cand, starts, qb, cell, cut, k, chunk, window)
    ref = nk.window_table_slab_plain(*args)
    got = nk.window_table_slab_compact(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    return ref


def edit(case, rng):
    """(centers, cand, starts, qbounds, window) of a hand-edited case."""
    centers, cand, starts, qb, cell, cut, plan = bench_layout(2048)
    centers, cand, starts, qb = (a.clone() for a in (centers, cand, starts,
                                                     qb))
    n_chunks = starts.shape[0]
    w = plan.window
    pick = torch.from_numpy(rng.random(n_chunks) < 0.5)
    if case == "empty runs":  # qlo == qhi, and qlo > qhi
        qb[pick, 1, 1] = qb[pick, 1, 0]
        qb[~pick, 0, 0] = qb[~pick, 0, 1] + 1.0
    elif case == "whole-window runs":  # every column of the run in range
        qb[pick, 0, 0] = -float("inf")
        qb[pick, 0, 1] = float("inf")
        qb[:, 2, 0] = -float("inf")
        qb[:, 2, 1] = float("inf")
    elif case == "overlapping runs":  # run 1 repeats run 0's rows
        starts[pick, 1] = starts[pick, 0]
        qb[pick, 1] = qb[pick, 0]
        qb[~pick, 1, 0] -= 0.5
    elif case == "unsorted keys":  # columns in random key order
        perm = torch.from_numpy(rng.permutation(cand.shape[1]))
        cand = cand[:, perm].contiguous()
    elif case == "all-filler chunks":
        for ch in np.flatnonzero(pick.numpy())[:8]:
            rows = slice(ch * plan.chunk, (ch + 1) * plan.chunk)
            centers[rows, 3] = -1.0
            centers[rows, 4] = -1.0
    elif case == "staging flush":  # 3 x 512 columns, all in range
        w = 512
        starts.clamp_(max=cand.shape[1] - w)
        qb[:, :, 0] = -float("inf")
        qb[:, :, 1] = float("inf")
    return centers, cand, starts, qb, cell, cut, plan.chunk, w


@pytest.mark.parametrize("triclinic,k", [(False, 8), (False, 16),
                                         (True, 8), (True, 1)])
def test_twin_equals_plain_on_bench_layout(triclinic, k):
    """Bench recipe at 4096 atoms, cubic and triclinic: about a third of
    the chunks hold only fillers and the key masks keep ~1/8 of the
    columns; at K 1 most live centers overflow."""
    centers, cand, starts, qb, cell, cut, plan = bench_layout(4096,
                                                              triclinic=triclinic)
    live = live_per_chunk(centers, plan.chunk)
    assert int((live == 0).sum()) > 0 and int((live > 0).sum()) > 0
    kept, _ = nk.slab_kept_columns(cand, starts, qb, plan.window)
    assert 0 < int(kept.sum()) < kept.numel() // 4
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, k,
                                   plan.chunk, plan.window)
    assert int(ref[2].sum()) > 0
    if k == 1:
        assert int((ref[2] > k).sum()) > 0


def test_twin_equals_plain_at_bench_size():
    """The bench glass's 10240 atoms at the fused step's K 8."""
    centers, cand, starts, qb, cell, cut, plan = bench_layout(10240)
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, 8,
                                   plan.chunk, plan.window)
    assert int(ref[2].sum()) > 1000


@pytest.mark.parametrize("case", ["empty runs", "whole-window runs",
                                  "overlapping runs", "unsorted keys",
                                  "all-filler chunks", "staging flush"])
@pytest.mark.parametrize("k", [2, 8])
def test_twin_equals_plain_on_edited_layouts(case, k):
    centers, cand, starts, qb, cell, cut, chunk, w = edit(
        case, np.random.default_rng(len(case)))
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, k,
                                   chunk, w)
    assert int(ref[2].sum()) > 0
    if case == "staging flush":  # more kept columns than one staging
        kept, _ = nk.slab_kept_columns(cand, starts, qb, w)
        assert int(kept.sum(dim=1).max()) > min(3 * w, nk.SLAB_PASS)


def test_twin_keeps_a_chunk_with_one_live_center():
    """Every center of a chunk but one made a filler (species and global
    index -1): the chunk's one live center keeps its neighbours."""
    centers, cand, starts, qb, cell, cut, plan = bench_layout(2048)
    ref = nk.window_table_slab_plain(centers, cand, starts, qb, cell, cut,
                                     8, plan.chunk, plan.window)
    centers = centers.clone()
    live = live_per_chunk(centers, plan.chunk)
    for ch in torch.nonzero(live > 1)[:, 0].tolist()[:4]:
        rows = torch.arange(ch * plan.chunk, (ch + 1) * plan.chunk)
        keep = rows[(ref[2][rows] > 0) & (centers[rows, 3] >= 0)]
        if keep.numel() == 0:
            continue
        drop = rows[rows != keep[0]]
        centers[drop, 3] = -1.0
        centers[drop, 4] = -1.0
    assert int((live_per_chunk(centers, plan.chunk) == 1).sum()) >= 2
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, 8,
                                   plan.chunk, plan.window)
    ones = live_per_chunk(centers, plan.chunk) == 1
    assert int(ref[2].reshape(-1, plan.chunk)[ones].sum()) > 0


@pytest.mark.parametrize("k", [8, 16])
def test_twin_equals_plain_on_a_crowded_center(k):
    """Twenty N atoms within 1.7 A of the first Zn: its count passes K
    (cnt > K flags the overflow; the first K slots are written)."""
    centers, cand, starts, qb, cell, cut, plan = bench_layout(2048, crowd=20)
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut, k,
                                   plan.chunk, plan.window)
    assert int(ref[2].max()) > k


def test_twin_equals_plain_at_k_1024():
    """K 1024: one center a block (its 1024 slots fill the tile)."""
    assert nk.slab_centers_per_block(16, 1024) == 1
    centers, cand, starts, qb, cell, cut, plan = bench_layout(2048, crowd=20)
    ref = assert_twin_equals_plain(centers, cand, starts, qb, cell, cut,
                                   1024, plan.chunk, plan.window)
    assert int(ref[2].max()) > 16
    assert bool((ref[1][:, 64:] == -1).all())


@pytest.mark.parametrize("triclinic", [False, True])
def test_twin_equals_pallas_interpret(triclinic):
    """The twin on the JAX package's own slab layout equals
    ``pallas_window_table_slab`` run in interpret mode (positions on the
    1/32 A grid, where XLA:CPU's contracted multiply-adds are exact)."""
    cutoff = np.array([[2.2, 2.0, 1.8], [2.0, 1.6, 2.4], [1.8, 2.4, 0.0]],
                      np.float32)
    pos, cell, sp = grid_case(2048, 3, 12, triclinic, box=32.0,
                              pad_from=2000)
    plan = jax_slab.slab_plan(cell, float(cutoff.max()), 2048,
                              positions=pos[None], species_idx=sp)
    assert plan is not None
    lay = jax_slab.build_slab_layout(jnp.asarray(pos), jnp.asarray(sp),
                                     jnp.asarray(cell), plan)
    centers, cand, starts, qb, _ = (np.asarray(a) for a in lay)
    k = 12
    ref = jax_nb.pallas_window_table_slab(
        centers, cand, starts, qb, cell, cutoff, 3, k, plan.chunk,
        plan.window, interpret=True)
    got = nk.window_table_slab_compact(
        t(centers), t(cand), t(starts), t(qb), t(cell), t(cutoff), k,
        plan.chunk, plan.window)
    assert int(got[2].sum()) > 0
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("chunk,k,cpb", [(16, 8, 16), (16, 64, 16),
                                         (16, 128, 8), (16, 1024, 1),
                                         (48, 8, 16), (24, 8, 12),
                                         (17, 8, 1), (64, 16, 16),
                                         (7, 200, 1)])
def test_centers_per_block(chunk, k, cpb):
    """The largest divisor of the chunk up to 16 whose cpb * K slots fit
    the 1024-slot tile (the CUDA source's rule; the card test holds the
    two equal)."""
    assert nk.slab_centers_per_block(chunk, k) == cpb


def test_cpu_wrapper_is_the_plain_version():
    centers, cand, starts, qb, cell, cut, plan = bench_layout(2048)
    before = launches("window_table_slab")
    args = (centers, cand, starts, qb, cell, cut, 8, plan.chunk, plan.window)
    got = nk.window_table_slab(*args)
    assert launches("window_table_slab") == before
    for g, r in zip(got, nk.window_table_slab_plain(*args)):
        assert torch.equal(g, r)
