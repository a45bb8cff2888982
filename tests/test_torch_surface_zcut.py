"""The z cut of kernel #6 (surface-point blockers), on its plain twin.

``grid_kernel.surface_z_window`` gives, for each group of consecutive
centers that the CUDA kernel runs as one block, the blocker rows it stages.
The plain version ``surface_valid_tiles_plain`` run on each group over only
those rows must give the validity and voxel indices of the full plain
version over every row of the column's three runs, bit for bit: the cut may
only drop rows that cannot block a point. Tolerance: exact (boolean and
integer outputs); against ``amof_tpu``'s XLA column pass, the borderline
rule of ``tests/test_torch_pore_surface.py``.

Inputs: cubic and sheared (triclinic) cells, the void slab (z squeezed to
72%), blockers at a point's reach edge and a few ulps either side of it, a
window that wraps z and one that covers all of z, a degenerate cell, ragged
columns and a column past ``col_cap``, K = 6 (axis directions), 8 and 28.

Mutations of the twin tried, each failing at least one test here: the
point reach P left out of the margin (rows within R_i + probe of a center
dropped); P taken as R_i, without the probe; the periodic wrap of the
per-row distance left out; the group's own centers left out of the rows
(self-exclusion by group instead of by point). Setting mu and SIGMA to 0
fails none: they cover rounding only, a few ulps, which these inputs do
not reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu_torch.pore import grid_kernel as gk
from test_torch_pore_surface import GRID, KW, compare

torch.set_num_threads(2)

AXES = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                 [0, 0, -1]], np.float32)


def system(seed, n=700, box=18.0, squeeze=1.0, dyadic=False):
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3))
    frac[:, 2] *= squeeze
    radii = rng.uniform(1.1, 1.9, n)
    if dyadic:
        frac = np.round(frac * 256) / 256
        radii = rng.choice([1.25, 1.5, 1.75], n)
    cell = np.eye(3, dtype=np.float32) * box
    return (frac % 1.0).astype(np.float32), cell, radii.astype(np.float32)


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def group_plain(lay, cell, inv, dirs, probe, grid, nbx, nby, col, g0, g1,
                rows):
    """The plain version over the centers [g0, g1) of column ``col`` and
    the blocker rows ``rows`` only: a layout whose one column holds the
    group as one slot and whose one run holds those rows."""
    n_cols = lay.cand_end.shape[0]
    cb = torch.full((n_cols + 1,), g1, dtype=torch.int32)
    cb[:col + 1] = g0
    ce = lay.cand_end.clone()
    ce[col] = g1
    nk = len(rows)
    blk = lay.blockers[:, rows] if nk else lay.blockers[:, :1]
    start = torch.zeros_like(lay.b_start)
    count = torch.zeros_like(lay.b_count)
    count[col, 0] = nk
    lay_g = lay._replace(c_bounds=cb, cand_end=ce,
                         blockers=blk.contiguous(), b_start=start,
                         b_count=count)
    return gk.surface_valid_tiles_plain(lay_g, cell, inv, dirs, probe, grid,
                                        nbx, nby, max(nk, 1), 1, g1 - g0)


def check_cut(frac, cell, radii, dirs, grid=GRID, nbx=3, nby=3, window=448,
              chunk=64, col_cap=128, cand_mask=None, probe=1.2):
    """Asserts that every group's plain result over its kept rows equals
    the full plain version on the group's rows, and that the groups cover
    exactly the rows the full version computes. Returns (full outputs,
    groups, keep, ok, layout)."""
    f, c, r, d = tensors(frac, cell, radii, dirs)
    inv = gk.host_inverse(c)
    m = None if cand_mask is None else torch.from_numpy(cand_mask)
    lay = gk.surface_layout(f, inv, r, probe, d, grid, nbx, nby, window,
                            col_cap, m)
    n_z = -(-col_cap // chunk)
    full = gk.surface_valid_tiles_plain(lay, c, inv, d, probe, grid, nbx,
                                        nby, window, n_z, chunk)
    group = gk.surface_group_size(d.shape[0])
    (cols, g0s, g1s), keep = gk.surface_z_window(
        lay, c, d, probe, n_z, chunk, group, window)
    _, ok = gk._gather_runs(lay.blockers, lay.b_start[cols],
                            lay.b_count[cols], window)
    w_idx = torch.arange(window)
    rows = (lay.b_start[cols][:, :, None] + w_idx).reshape(len(cols), -1)
    assert not bool((keep & ~ok).any())
    covered = torch.zeros(frac.shape[0], dtype=torch.bool)
    for i, (col, g0, g1) in enumerate(zip(cols, g0s, g1s)):
        assert 0 < g1 - g0 <= group
        sub = group_plain(lay, c, inv, d, probe, grid, nbx, nby, int(col),
                          int(g0), int(g1), rows[i][keep[i]].long())
        for got, ref in zip(sub, full):
            assert torch.equal(got[g0:g1], ref[g0:g1]), (col, g0, g1)
        assert not bool(covered[g0:g1].any())
        covered[g0:g1] = True
    # rows outside the groups: False and index 0
    assert not bool(full[0][~covered].any())
    assert not bool(full[1][~covered].any())
    assert not bool(full[2][~covered].any())
    cs, los, his = gk.active_slots(lay, n_z, chunk)
    assert int(covered.sum()) == int(np.sum(his - los))
    return full, (cols, g0s, g1s), keep, ok, lay


def kept_share(keep, ok):
    return float(keep.sum()) / float(ok.sum())


@pytest.mark.parametrize("k", [8, 28])
@pytest.mark.parametrize("squeeze", [1.0, 0.72])
def test_cut_on_cubic_frames(k, squeeze):
    frac, cell, radii = system(1, squeeze=squeeze)
    full, _, keep, ok, _ = check_cut(frac, cell, radii,
                                     gk.fibonacci_sphere(k))
    # the dense frame buries every point; the void slab leaves a surface
    assert (0 < int(full[0].sum())) == (squeeze < 1.0)
    assert kept_share(keep, ok) < 0.8  # the cut drops rows


@pytest.mark.parametrize("k", [8, 28])
def test_cut_on_a_sheared_triclinic_cell(k):
    frac, _, radii = system(2, n=800, squeeze=0.72)
    cell = np.array([[18.0, 0, 0], [2.1, 17.2, 0], [-3.3, 2.9, 26.0]],
                    np.float32)
    full, _, keep, ok, _ = check_cut(frac, cell, radii,
                                     gk.fibonacci_sphere(k))
    assert 0 < int(full[0].sum()) < full[0].numel()
    assert kept_share(keep, ok) < 0.7


def test_cut_under_the_candidate_prefilter():
    """The void slab with a channel-mask prefilter: groups split at each
    column's candidate end, non-candidates of active slots included."""
    frac, cell, radii = system(3, squeeze=0.72)
    cand = np.random.default_rng(4).random(GRID) < 0.05
    full, (cols, g0s, g1s), _, _, lay = check_cut(
        frac, cell, radii, gk.fibonacci_sphere(8), cand_mask=cand)
    ce = lay.cand_end.numpy()
    # no group straddles a column's candidate end
    assert all(not (g0 < ce[c] < g1) for c, g0, g1 in zip(cols, g0s, g1s))
    assert any(g0 >= ce[c] for c, g0 in zip(cols, g0s))
    assert 0 < int(full[0].sum())


def test_cut_with_blockers_at_the_reach_edge():
    """Blockers right above a center's +z point at R_i + probe + R_j +
    probe - 1e-4 from the center, a few ulps either side and 0.01 A
    inside: those within reach block the point, and all of them are kept
    and change no result."""
    box = 16.0
    frac, cell, radii = system(5, n=300, box=box, dyadic=True)
    rp = np.float32(1.2)
    peps = np.float32(rp - np.float32(1e-4))
    extra_f, extra_r, probes = [], [], []
    for x, y, z in [(0.5078125, 0.2578125, 0.25), (0.1640625, 0.8359375,
                                                    0.9609375),
                    (0.83203125, 0.58203125, 0.0234375)]:
        ri, rj = np.float32(1.5), np.float32(1.25)
        reach = np.float32((ri + rp) + (rj + peps))
        base = np.float32(z + reach / np.float32(box))
        tops = [np.float32(base - np.float32(0.01) / np.float32(box))]
        v = base
        for _ in range(3):
            v = np.nextafter(v, np.float32(-1))
        for _ in range(7):  # base - 3 ulps .. base + 3 ulps
            tops.append(v)
            v = np.nextafter(v, np.float32(2))
        extra_f.append((x, y, z))
        extra_r.append(ri)
        probes.append(len(frac) + len(extra_f) - 1)
        for top in tops:
            extra_f.append((x, y, float(top) % 1.0))
            extra_r.append(rj)
    frac = np.concatenate([frac, np.array(extra_f, np.float32)])
    radii = np.concatenate([radii, np.array(extra_r, np.float32)])
    full, (cols, g0s, g1s), keep, ok, lay = check_cut(
        frac, cell, radii, AXES, window=448)
    order = lay.centers[4].long()
    row_of = torch.empty_like(order)
    row_of[order] = torch.arange(len(order))
    for i in probes:
        a = int(row_of[i])
        assert not bool(full[0][a, 4]), "the +z point is not blocked"


def test_cut_with_windows_that_wrap_and_cover_z():
    """Groups near z = 0 and 1 take rows across the periodic boundary; in a
    cell of 8 A in z every group's window covers all of z and keeps every
    row."""
    frac, cell, radii = system(6, squeeze=1.0)
    _, (cols, g0s, g1s), keep, ok, lay = check_cut(
        frac, cell, radii, gk.fibonacci_sphere(8))
    fz = lay.centers[2]
    (_, _, bz, _, _), _ = gk._gather_runs(
        lay.blockers, lay.b_start[cols], lay.b_count[cols], 448)
    low = torch.tensor([float(fz[g0:g1].max()) < 0.08
                        for g0, g1 in zip(g0s, g1s)])
    assert bool(low.any())
    assert bool((keep[low] & (bz[low] > 0.9)).any()), "no wrapped row kept"

    flat = cell.copy()
    flat[2, 2] = 8.0
    frac2, _, radii2 = system(7, n=300)
    _, _, keep2, ok2, _ = check_cut(frac2, flat, radii2,
                                    gk.fibonacci_sphere(8))
    assert torch.equal(keep2, ok2)


@pytest.mark.parametrize("window,col_cap", [(448, 32), (40, 128)])
def test_cut_on_ragged_and_overfull_columns(window, col_cap):
    """Atoms crowded into part of the box (columns of very different
    sizes); a column past ``col_cap`` (its rows past n_z * chunk stay
    False / 0) and runs cut at ``window`` rows."""
    rng = np.random.default_rng(8)
    frac, cell, radii = system(8, n=500)
    crowd = rng.random((400, 3)) * np.array([0.3, 0.3, 1.0])
    frac = np.concatenate([frac, crowd.astype(np.float32)])
    radii = np.concatenate([radii, rng.uniform(1.1, 1.9, 400).astype(
        np.float32)])
    check_cut(frac, cell, radii, gk.fibonacci_sphere(8), window=window,
              col_cap=col_cap, chunk=32)


def test_a_degenerate_cell_keeps_every_row():
    """h_z = 0: nothing is provably out of reach, so nothing is dropped."""
    frac, cell, radii = system(9, n=300)
    f, r = tensors(frac, radii)
    d = torch.from_numpy(gk.fibonacci_sphere(8))
    inv = gk.host_inverse(torch.from_numpy(cell))
    lay = gk.surface_layout(f, inv, r, 1.2, d, GRID, 3, 3, 448, 128)
    flat = torch.tensor([[18.0, 0, 0], [0, 18.0, 0], [4.0, 4.0, 0]])
    (cols, _, _), keep = gk.surface_z_window(lay, flat, d, 1.2, 2, 64, 8,
                                             448)
    _, ok = gk._gather_runs(lay.blockers, lay.b_start[cols],
                            lay.b_count[cols], 448)
    assert torch.equal(keep, ok)


def test_kept_rows_match_xla_column_pass():
    """Validity over the kept rows, gathered group by group, against
    ``amof_tpu``'s XLA column pass on the same numpy inputs (per atom)."""
    frac, cell, radii = system(10, squeeze=0.72)
    k = 8
    dirs = gk.fibonacci_sphere(k)
    full, (cols, g0s, g1s), keep, _, lay = check_cut(frac, cell, radii,
                                                     dirs, **KW)
    got = [t.numpy() for t in (*full, lay.centers[4].to(torch.int32),
                               lay.centers[3], lay.missed)]
    ref = [np.asarray(x) for x in jgk.surface_valid_columns(
        jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), 1.2,
        jnp.asarray(dirs), GRID, chunk=32, **KW)]
    ax, _ = compare(frac, cell, radii, k, ref, got, dirs)
    assert 0 < ax[0].sum() < ax[0].size
