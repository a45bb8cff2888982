"""Parity of the port's surface blocker pass (kernel #6's plain version,
run by ``surface_kernel.surface_valid_columns`` on CPU tensors) with the
JAX package's XLA column pass ``grid_kernel.surface_valid_columns``
(chunk 32), on the same numpy inputs.

The two slot layouts differ (the port keeps one row per atom in its
center order, ``amof_tpu`` pads 32-atom chunks), so outputs are compared
per atom, mapped back by ``orig_idx`` as ``tests/test_surface_pallas.py``
does. Under the candidate prefilter only candidate atoms are compared
(a non-candidate's validity depends on which slot it shares with a
candidate; its points land on code-0 voxels and never count), and the
``classify_surface_points`` sums must be equal.

Tolerances: validity, voxel indices, candidate flags, sums and the missed
flag are equal. The sphere points are generic floats (Fibonacci
directions), and XLA:CPU may contract ``c + r * dir`` into an FMA where
the port rounds twice; a differing point is therefore allowed only if it
is borderline: float64 |d^2 - (R_j + probe - 1e-4)^2| within 64 float32
ulps of the threshold for a validity difference, and a fractional
coordinate times the grid dim within 64 ulps of an integer for an index
difference. At most 0.1% of the points may differ at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu_torch.pore import grid_kernel, surface_kernel

torch.set_num_threads(2)

GRID = (16, 16, 16)
KW = dict(nbx=3, nby=3, window=448, col_cap=128)
ULPS = 64 * 2.0**-23


def system(seed, n=700, box=18.0):
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3)).astype(np.float32)
    frac[:, 2] *= 0.72  # void slab: nonzero surface
    cell = np.eye(3, dtype=np.float32) * box
    radii = rng.uniform(1.2, 1.9, n).astype(np.float32)
    return frac, cell, radii


def per_atom(valid, gis, i1, i2, n, k):
    valid, gis = np.asarray(valid), np.asarray(gis)
    i1, i2 = np.asarray(i1), np.asarray(i2)
    live = gis >= 0
    assert np.bincount(gis[live], minlength=n).max() <= 1
    v = np.zeros((n, k), bool)
    a1 = np.zeros((n, k), np.int64)
    a2 = np.zeros((n, k), np.int64)
    v[gis[live]] = valid[live]
    a1[gis[live]] = i1[live]
    a2[gis[live]] = i2[live]
    return v, a1, a2, live.sum()


def run_both(frac, cell, radii, k, cand_mask=None, **kw):
    kw = {**KW, **kw}
    dirs = grid_kernel.fibonacci_sphere(k)
    jm = None if cand_mask is None else jnp.asarray(cand_mask)
    ref = jgk.surface_valid_columns(
        jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), 1.2,
        jnp.asarray(dirs), GRID, chunk=32, cand_mask=jm, **kw)
    tm = None if cand_mask is None else torch.from_numpy(cand_mask)
    got = surface_kernel.surface_valid_columns(
        torch.from_numpy(frac), torch.from_numpy(cell),
        torch.from_numpy(radii), 1.2, torch.from_numpy(dirs), GRID,
        chunk=64, cand_mask=tm, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got], dirs


def points64(frac, cell, radii, dirs):
    """float64 sphere points [N, K, 3] (Cartesian) of every atom."""
    c = frac.astype(np.float64) @ cell.astype(np.float64)
    r = radii.astype(np.float64)[:, None, None] + 1.2
    return c[:, None, :] + r * dirs.astype(np.float64)[None]


def assert_borderline(frac, cell, radii, dirs, diff_v, diff_i):
    """Each (atom, k) in diff_v has a blocker at threshold within ULPS,
    each in diff_i a fractional coordinate at a voxel boundary."""
    p = points64(frac, cell, radii, dirs)
    cell64 = cell.astype(np.float64)
    inv64 = np.linalg.inv(cell64)
    img = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)], np.float64)
    cart = frac.astype(np.float64) @ cell64
    for a, k in diff_v:
        d = p[a, k][None, None, :] - (cart[:, None, :] + img @ cell64)
        d2 = (d * d).sum(-1).min(axis=1)
        th = (radii.astype(np.float64) + 1.2 - 1e-4) ** 2
        rel = np.abs(d2 - th) / th
        rel[a] = np.inf
        assert rel.min() < ULPS, (a, k, rel.min())
    for a, k in diff_i:
        f = p[a, k] @ inv64
        fg = (f - np.floor(f)) * np.array(GRID)
        fgn = ((f + 0.2 * dirs[k] @ inv64) % 1.0) * np.array(GRID)
        near = min(np.abs(fg - np.round(fg)).min(),
                   np.abs(fgn - np.round(fgn)).min())
        assert near < ULPS * max(GRID), (a, k, near)


def compare(frac, cell, radii, k, ref, got, dirs, rows=None):
    n = len(frac)
    ax = per_atom(ref[0], ref[3], ref[1], ref[2], n, k)
    at = per_atom(got[0], got[3], got[1], got[2], n, k)
    assert at[3] == n
    sel = np.ones(n, bool) if rows is None else rows
    dv = np.argwhere((ax[0] != at[0]) & sel[:, None])
    di = np.argwhere(((ax[1] != at[1]) | (ax[2] != at[2])) & sel[:, None])
    assert len(dv) + len(di) <= 1e-3 * sel.sum() * k
    assert_borderline(frac, cell, radii, dirs, dv, di)
    return ax, at


@pytest.mark.parametrize("seed,k", [(0, 8), (3, 8), (4, 28)])
def test_all_atoms_match_xla(seed, k):
    frac, cell, radii = system(seed)
    ref, got, dirs = run_both(frac, cell, radii, k)
    assert bool(ref[5]) == bool(got[5]) is False
    ax, _ = compare(frac, cell, radii, k, ref, got, dirs)
    assert 0 < ax[0].sum() < ax[0].size


def test_candidate_atoms_and_sums_match_under_prefilter():
    frac, cell, radii = system(11)
    rng = np.random.default_rng(5)
    acc = rng.random(GRID) < 0.10
    poc = (~acc) & (rng.random(GRID) < 0.05)
    cand_mask = acc | poc
    ref, got, dirs = run_both(frac, cell, radii, 8, cand_mask)
    assert not bool(ref[5]) and not bool(got[5])

    inv = jnp.linalg.inv(jnp.asarray(cell))
    cand_ref = np.asarray(jgk.surface_candidate_mask(
        jnp.asarray(frac), inv, jnp.asarray(radii), 1.2, jnp.asarray(dirs),
        GRID, jnp.asarray(cand_mask)))
    cand = grid_kernel.surface_candidate_mask(
        torch.from_numpy(frac),
        grid_kernel.host_inverse(torch.from_numpy(cell)),
        torch.from_numpy(radii), 1.2, torch.from_numpy(dirs), GRID,
        torch.from_numpy(cand_mask)).numpy()
    np.testing.assert_array_equal(cand, cand_ref)
    assert 0 < cand.sum() < len(cand)
    compare(frac, cell, radii, 8, ref, got, dirs, rows=cand)

    sums = {}
    for name, out in (("jax", ref), ("port", got)):
        a, na = jgk.classify_surface_points(
            jnp.asarray(out[0]), jnp.asarray(out[1]), jnp.asarray(out[2]),
            jnp.asarray(acc), jnp.asarray(poc))
        if name == "port":
            a2, na2 = grid_kernel.classify_surface_points(
                *(torch.from_numpy(o) for o in out[:3]),
                torch.from_numpy(acc), torch.from_numpy(poc))
            np.testing.assert_array_equal(a2.numpy(), np.asarray(a))
            np.testing.assert_array_equal(na2.numpy(), np.asarray(na))
        sums[name] = (int(np.asarray(a).sum()), int(np.asarray(na).sum()))
    assert sums["jax"] == sums["port"]
    assert sums["jax"][0] > 0 and sums["jax"][1] > 0


@pytest.mark.parametrize("window,col_cap", [(64, 128), (448, 32)])
def test_missed_flag(window, col_cap):
    frac, cell, radii = system(4)
    ref, got, _ = run_both(frac, cell, radii, 8, window=window,
                           col_cap=col_cap)
    assert bool(ref[5]) == bool(got[5]) is True


@pytest.mark.parametrize("masked", [False, True])
def test_centers_at_the_top_of_z_stay_in_their_column(masked):
    """Kernel #6's layout puts every center in its own column's range of
    rows, candidates first, for atoms a float32 ulp below fz = 1 in the
    last column too. The sort key was ``col + fz / 2`` (non-candidates
    ``col + 0.5 + fz / 2``) in float32, which rounds up to the next part:
    a candidate of the last column then sorted among its non-candidates,
    and a non-candidate past ``c_bounds[C]``, outside every column, where
    kernel #6 left its row unwritten and the plain version dropped it.
    ``masked``: candidates from a slab of voxels in the middle of z, so
    the atoms near z = 1 are non-candidates; else every atom is one."""
    frac, cell, radii = system(5)
    top = np.float32(1.0) - np.float32(2.0**-24)
    frac[:4, 0] = frac[:4, 1] = [0.70, 0.80, 0.90, 0.96]
    frac[:4, 2] = [top, np.nextafter(top, 0), 0.0, top]
    cand_mask = None
    if masked:
        cand_mask = np.zeros(GRID, bool)
        cand_mask[:, :, 6:8] = True
    f, c, r = (torch.from_numpy(a) for a in (frac, cell, radii))
    dirs = torch.from_numpy(grid_kernel.fibonacci_sphere(8))
    inv = grid_kernel.host_inverse(c)
    tm = None if cand_mask is None else torch.from_numpy(cand_mask)
    lay = grid_kernel.surface_layout(f, inv, r, 1.2, dirs, GRID, 3, 3, 448,
                                     128, tm)
    cand = grid_kernel.surface_candidate_mask(f, inv, r, 1.2, dirs, GRID,
                                              tm).numpy()
    assert cand[:4].all() != masked
    cb, ce = lay.c_bounds.numpy(), lay.cand_end.numpy()
    assert cb[0] == 0 and cb[-1] == len(frac)
    gis = lay.centers[4].numpy().astype(np.int64)
    col = (np.minimum((frac[gis, 0] * 3).astype(int), 2) * 3
           + np.minimum((frac[gis, 1] * 3).astype(int), 2))
    rows = np.arange(len(frac))
    assert (cb[col] <= rows).all() and (rows < cb[col + 1]).all()
    assert ((rows < ce[col]) == cand[gis]).all()
    # z sorted within each part of a column
    fz = lay.centers[2].numpy()
    same = (col[1:] == col[:-1]) & (cand[gis][1:] == cand[gis][:-1])
    assert (fz[1:][same] >= fz[:-1][same]).all()
    # the plain version tests every candidate row (all columns fit col_cap)
    valid, i_pt, i_nu = grid_kernel.surface_valid_tiles_plain(
        lay, c, inv, dirs, 1.2, GRID, 3, 3, 448, 2, 64)
    _, los, his = grid_kernel.active_slots(lay, 2, 64)
    active = np.zeros(len(frac), bool)
    for lo, hi in zip(los, his):
        active[lo:hi] = True
    assert active[cand[gis]].all()
    n_vox = GRID[0] * GRID[1] * GRID[2]
    assert 0 <= int(i_pt.min()) and int(i_pt.max()) < n_vox
    assert 0 <= int(i_nu.min()) and int(i_nu.max()) < n_vox
