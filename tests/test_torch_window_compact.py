"""Kernel #4's decomposition (the 1-level sorted-window K-slot neighbour
table), on its plain twin.

``neighbor_kernel.window_table_compact`` runs the table as the CUDA kernel
does: blocks of ``window_centers_per_block`` consecutive centers of one
chunk (the last block of a chunk short when that number does not divide
it); a block whose centers are all fillers writes empty rows and touches
no candidate; otherwise only the window columns that are real and lie
within the exact fractional-x reach of the block's live centers
(``window_kept_columns``, argued in ``csrc/window_table.cu``'s header) are
staged in column order and tested, a pair that the y/z prefilter
(``window_prefilter``) skips counting as invalid. It must equal the plain version
``window_table_plain`` (every column tested) bit for bit: positions,
species and counts. Tolerance: exact. Every case also checks that the cut
dropped columns (fewer kept than the window holds), so it is exercised.

Inputs: the bench glass recipe (Zn(C3N2H3)2 at 0.062 atoms/A^3, bench.py's
cutoffs) in cubic and strongly sheared cells; pairs placed at the cut's
reach (rc (1 + d) along the normal of the b x c plane, d a few position
ulps either side of 0) with partners outside the box; every position
moved by whole cell vectors (far outside the box); windows that wrap
across the sorted ends; pads and a run of sorted fillers (fillers-only
blocks); chunks 100, 24 and 17 (not divided by 16; n not a multiple of
the chunk); K 1, 16, 32 and 1024 with rows over K; and cases against
``amof_tpu``'s ``pallas_window_table`` in interpret mode, as
``tests/test_torch_neighbors.py`` runs it.

Mutations of the twin tried, each failing at least one test here: the
arc's half-width dropped; the arc reduced to the block's first live
center; rc taken as the smallest cutoff; w0 taken as |a| (fails on the
sheared cells); the column's row counted from the block's first row
instead of the chunk's; the pair prefilter's y and z reaches swapped.
Dropping the 2^-20 margin fails none: it covers f32 rounding that these
inputs do not reach, and the argument in the CUDA source's header, not a
test, carries it.
"""

import numpy as np
import pytest
import torch

from amof_tpu.ops import pallas_neighbors as jax_nb
from amof_tpu_torch.ops import neighbor_kernel as nk
from amof_tpu_torch.ops import pair_engine

from test_torch_kernels import (BENCH_CUT, CUTOFF, bench_glass, case,
                                crowd_first_zn, launches, reach_edge)
from test_torch_rdf import grid_case, t

torch.set_num_threads(2)


def sheared(n, seed=0):
    """The bench glass recipe in a strongly sheared cell (b and c leaning
    60% and 45% of the box along x, c 35% along y)."""
    pos, cell, sp, _ = bench_glass(n, seed)
    box = float(cell[0, 0])
    cell = cell.copy()
    cell[1, 0], cell[2, 0], cell[2, 1] = 0.6 * box, -0.45 * box, 0.35 * box
    frac = pos / box
    return (frac @ cell).astype(np.float32), cell, sp


def sort(pos, cell, sp):
    p, c, s = t(pos), t(cell), t(sp)
    _, pos_s, sp_s = pair_engine.sort_by_fractional_x(
        p, s, pair_engine.inverse_cell(c))
    return pos_s, sp_s, c


def assert_twin_equals_plain(pos_s, sp_s, c, cut, k, chunk, window):
    """Twin == plain, bit for bit; the cut drops columns. Returns the
    plain table and the kept mask."""
    args = (pos_s, sp_s, c, cut, k, chunk, window)
    ref = nk.window_table_plain(*args)
    got = nk.window_table_compact(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    kept, live, *_ = nk.window_kept_columns(*args)
    assert int(kept[live > 0].sum()) < int((live > 0).sum()) * kept.shape[1]
    return ref, kept


@pytest.mark.parametrize("cell_kind,k", [("cubic", 16), ("cubic", 32),
                                         ("sheared", 16), ("sheared", 1)])
def test_twin_equals_plain_on_bench_glass(cell_kind, k):
    """4096 atoms of the bench glass at the reruns' chunk 256 (W 640):
    the cut keeps about a third of each window; at K 1 most rows
    overflow."""
    if cell_kind == "cubic":
        pos, cell, sp, _ = bench_glass(4096)
    else:
        pos, cell, sp = sheared(4096)
    ref, kept = assert_twin_equals_plain(*sort(pos, cell, sp), t(BENCH_CUT),
                                         k, 256, 640)
    assert int(ref[2].sum()) > 1000
    assert float(kept.float().mean()) < 0.6
    if k == 1:
        assert int((ref[2] > k).sum()) > 100


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("k", [16, 1024])
def test_twin_equals_plain_at_the_reach_edge(triclinic, k):
    """120 pairs at rc (1 + d), d from -2e-5 to 2e-5, along the normal of
    the b x c plane, partners outside the box: the pairs just inside the
    cutoff are found, the cut keeps them (K 1024: one center a block)."""
    pos, cell, sp = case(3000, 3, 9, 36.0, triclinic, pad_from=2990)
    pos, sp = reach_edge(pos, cell, sp, CUTOFF)
    frac_x = (pos[1:240:2] @ np.linalg.inv(cell.astype(np.float64)))[:, 0]
    assert (frac_x >= 1).any() and (frac_x < 0).any()
    ref, _ = assert_twin_equals_plain(*sort(pos, cell, sp), t(CUTOFF), k,
                                      256, 512)
    if k == 1024:
        assert nk.window_centers_per_block(256, 1024) == 1
    # both sides of the edge occur: some partners within the cutoff
    d2 = pair_engine.squared_norm(pair_engine.min_image_delta(
        t(pos[1:240:2] - pos[0:240:2]), t(cell),
        pair_engine.inverse_cell(t(cell))))
    inside = d2 < float(CUTOFF.max()) ** 2
    assert bool(inside.any()) and not bool(inside.all())


def test_twin_equals_plain_far_outside_the_box():
    """Every position moved by +3 a - 2 b + 5 c (whole cell vectors): the
    cut's margin grows with the coordinates' size and still drops
    columns."""
    pos, cell, sp = sheared(2048, seed=3)
    pos = (pos + cell[0] * 3 - cell[1] * 2 + cell[2] * 5).astype(np.float32)
    ref, _ = assert_twin_equals_plain(*sort(pos, cell, sp), t(BENCH_CUT),
                                      16, 256, 384)
    assert int(ref[2].sum()) > 0


@pytest.mark.parametrize("chunk,window", [(100, 300), (24, 200),
                                          (17, 160)])
def test_twin_equals_plain_on_ragged_chunks(chunk, window):
    """Chunks 16 does not divide (a chunk's last block is short) and n
    not a multiple of the chunk (the last chunk is short); pads sorted in
    among the atoms."""
    pos, cell, sp = case(2047, 3, 4, 32.0, triclinic=True, pad_from=2000)
    pos_s, sp_s, c = sort(pos, cell, sp)
    assert pos_s.shape[0] % chunk != 0
    first, rows, _ = nk.window_blocks(2047, chunk, 16)
    assert int(rows.min()) < nk.window_centers_per_block(chunk, 16)
    assert int(rows.sum()) == 2047
    ref, _ = assert_twin_equals_plain(pos_s, sp_s, c, t(CUTOFF), 16, chunk,
                                      window)
    assert int(ref[2].sum()) > 0


def test_twin_skips_fillers_only_blocks_and_wraps_the_window():
    """A run of 80 sorted rows made fillers (four whole blocks and parts
    of two): those blocks are skipped, their rows stay empty; the first
    chunk's window starts W columns before sorted row 0, so its kept
    columns wrap to the end of the sorted order."""
    pos, cell, sp, _ = bench_glass(2048, seed=2)
    pos_s, sp_s, c = sort(pos, cell, sp)
    sp_s = sp_s.clone()
    sp_s[600:680] = -1
    args = (pos_s, sp_s, c, t(BENCH_CUT), 16, 256, 384)
    kept, live, first, rows, c0 = nk.window_kept_columns(*args)
    assert int((live == 0).sum()) >= 4
    assert bool((kept[c0 == 0][:, :384]).any())  # rows n - 384 .. n - 1
    ref, _ = assert_twin_equals_plain(*args)
    assert bool((ref[2][600:680] == 0).all())
    assert bool((ref[1][600:680] == -1).all())


@pytest.mark.parametrize("k", [1, 8, 16])
def test_twin_equals_plain_on_a_crowded_center(k):
    """Twenty N atoms within 1.7 A of the first Zn: its count passes K
    (cnt > K flags the overflow; the first K slots are written)."""
    pos, cell, sp, _ = bench_glass(2048)
    pos = crowd_first_zn(pos, cell, sp)
    ref, _ = assert_twin_equals_plain(*sort(pos, cell, sp), t(BENCH_CUT), k,
                                      256, 384)
    assert int(ref[2].max()) > k


@pytest.mark.parametrize("chunk,k,cpb", [(256, 16, 16), (256, 64, 16),
                                         (256, 128, 8), (256, 1024, 1),
                                         (100, 16, 16), (17, 8, 16),
                                         (7, 8, 7), (256, 0, 16),
                                         (256, 2048, 1)])
def test_centers_per_block(chunk, k, cpb):
    """min(16, chunk, 1024 // K), at least 1 (the CUDA source's rule; the
    card test holds the two equal)."""
    assert nk.window_centers_per_block(chunk, k) == cpb


@pytest.mark.parametrize("triclinic,k", [(False, 8), (True, 16), (False, 3)])
def test_twin_equals_pallas_interpret(triclinic, k):
    """The twin equals ``pallas_window_table`` run in interpret mode
    (positions on the 1/32 A grid, where XLA:CPU's contracted
    multiply-adds are exact), as tests/test_torch_neighbors.py runs it."""
    pos, cell, sp = grid_case(768, 3, 11, triclinic, box=16.0, pad_from=740)
    pos_s, sp_s, c = sort(pos, cell, sp)
    ref = jax_nb.pallas_window_table(pos_s.numpy(), sp_s.numpy(), cell,
                                     CUTOFF, 3, k, 128, 128, interpret=True)
    got = nk.window_table_compact(pos_s, sp_s, c, t(CUTOFF), k, 128, 128)
    kept, live, *_ = nk.window_kept_columns(pos_s, sp_s, c, t(CUTOFF), k,
                                            128, 128)
    assert int(kept.sum()) < kept.numel()
    if k == 3:
        assert int(got[2].max()) > k
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_cpu_wrapper_is_the_plain_version():
    pos, cell, sp, _ = bench_glass(2048)
    before = launches("window_table")
    args = (*sort(pos, cell, sp), t(BENCH_CUT), 16, 256, 384)
    got = nk.window_table(*args)
    assert launches("window_table") == before
    for g, r in zip(got, nk.window_table_plain(*args)):
        assert torch.equal(g, r)
