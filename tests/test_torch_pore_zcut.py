"""The z-slab candidate cut of kernel #5, on its plain twin.

``grid_kernel.void_masks_z_window`` gives, for each (xy tile, z slab),
the candidate rows the CUDA kernel stages. Running the plain version
``void_masks_tiles_plain`` over only those rows (the dropped rows made
non-candidates, as rows past a run's end are) must give the masks and MC
point fits of the full candidate set on that slab's voxels and points,
bit for bit: the cut may only drop rows that cannot flip a compare.
Tolerance: exact (boolean outputs).

Inputs: dyadic and random cubic frames, a sheared triclinic cell, the
void slab (z squeezed to 72%), atoms placed exactly at a slab's reach
edge and at the cut's own limit, and a missed run (window too small).
"""

import numpy as np
import pytest
import torch

from amof_tpu_torch.pore import grid_kernel as gk

torch.set_num_threads(2)

NB = 4
SLAB = gk.VOID_SLAB


def restricted_plain(lay, cell, grid, window, thr, pts, keep, s):
    """The plain version over the rows ``keep[:, s]`` only: every tile gets
    a private copy of its runs with the kept rows first, and each run's
    count covers just those."""
    n_tiles = NB * NB
    (fx, fy, fz, r), _ = gk._gather_runs(lay.payload, lay.start, lay.count,
                                         window)
    kk = keep[:, s].reshape(n_tiles, 3, window)
    order = torch.argsort((~kk).to(torch.int8), dim=2, stable=True)
    cols = [x.reshape(n_tiles, 3, window).gather(2, order).reshape(-1)
            for x in (fx, fy, fz, r)]
    start = (torch.arange(n_tiles * 3) * window).reshape(n_tiles, 3)
    lay_s = gk.MaskLayout(torch.stack(cols).contiguous(),
                          start.to(torch.int32), kk.sum(2).to(torch.int32),
                          lay.missed, lay.keys, lay.cstarts)
    return gk.void_masks_tiles_plain(lay_s, cell, grid, NB, NB, window,
                                     *thr, pts)


def point_slabs(pts, gz):
    """Slab of each MC point, as the kernel assigns it."""
    vz = pts[:, :, 2]
    kz = ((vz - torch.floor(vz)) * gz).to(torch.int32)
    return torch.clamp(kz, 0, gz - 1) // SLAB


def check_cut(frac, cell, radii, grid, probe, chan, window, with_pts=True,
              seed=0):
    """Asserts the restricted plain version equals the full one on every
    slab; returns (keep, layout)."""
    f, c, r = (torch.from_numpy(np.ascontiguousarray(a))
               for a in (frac, cell, radii))
    pts = None
    if with_pts:
        raw = np.random.default_rng(seed).random((2500, 3)).astype(
            np.float32)
        pts = torch.from_numpy(gk.assign_points_to_xytiles(
            raw, {"nbx": NB, "nby": NB})[0])
    lay = gk.masks_layout(f, r, NB, NB, window)
    thr = gk.mask_thresholds(probe, chan)
    hi, lo, fit = gk.void_masks_tiles_plain(lay, c, grid, NB, NB, window,
                                            *thr, pts)
    keep = gk.void_masks_z_window(lay, c, grid, NB, NB, window, thr[0])
    n_slabs = -(-grid[2] // SLAB)
    assert keep.shape == (NB * NB, n_slabs, 3 * window)
    slab_of = point_slabs(pts, grid[2]) if with_pts else None
    for s in range(n_slabs):
        hi_s, lo_s, fit_s = restricted_plain(lay, c, grid, window, thr, pts,
                                             keep, s)
        z = slice(s * SLAB, min((s + 1) * SLAB, grid[2]))
        assert torch.equal(hi_s[:, :, z], hi[:, :, z]), f"slab {s}"
        assert torch.equal(lo_s[:, :, z], lo[:, :, z]), f"slab {s}"
        if with_pts:
            m = slab_of == s
            assert torch.equal(fit_s[m], fit[m]), f"slab {s} points"
    assert 0 < int(hi.sum()) < hi.numel()  # non-degenerate masks
    return keep, lay


def background(seed, n, squeeze=1.0, dyadic=False):
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3))
    if dyadic:
        frac = np.round(frac * 512) / 512
    frac[:, 2] *= squeeze
    if dyadic:
        frac[:, 2] = np.round(frac[:, 2] * 512) / 512
    radii = (rng.choice([1.25, 1.5, 1.75], n) if dyadic
             else rng.uniform(1.1, 1.8, n))
    return (frac % 1.0).astype(np.float32), radii.astype(np.float32)


def kept_share(keep, lay, window):
    _, ok = gk._gather_runs(lay.payload, lay.start, lay.count, window)
    return float(keep.sum()) / (float(ok.sum()) * keep.shape[1])


@pytest.mark.parametrize("probe,chan", [(1.25, 1.25), (1.0, 1.25),
                                        (1.5, 1.0)])
@pytest.mark.parametrize("gz", [40, 36])
def test_cut_on_dyadic_cubic_frames(probe, chan, gz):
    frac, radii = background(1, 300, squeeze=0.72, dyadic=True)
    cell = np.eye(3, dtype=np.float32) * 16.0
    keep, lay = check_cut(frac, cell, radii, (16, 16, gz), probe, chan, 256)
    assert kept_share(keep, lay, 256) < 0.65  # the cut drops rows


@pytest.mark.parametrize("squeeze", [1.0, 0.72])
@pytest.mark.parametrize("with_pts", [True, False])
def test_cut_on_random_cubic_frames(squeeze, with_pts):
    frac, radii = background(2, 700, squeeze=squeeze)
    cell = np.eye(3, dtype=np.float32) * 19.7
    keep, lay = check_cut(frac, cell, radii, (16, 16, 44), 1.2, 1.2, 256,
                          with_pts=with_pts, seed=3)
    assert kept_share(keep, lay, 256) < 0.6


@pytest.mark.parametrize("probe,chan", [(1.2, 1.2), (1.0, 1.3)])
def test_cut_on_a_sheared_triclinic_cell(probe, chan):
    frac, radii = background(4, 500, squeeze=0.72)
    cell = np.array([[16.0, 0, 0], [1.4, 15.4, 0], [-2.9, 3.1, 31.8]],
                    np.float32)
    keep, lay = check_cut(frac, cell, radii, (16, 16, 60), probe, chan, 256,
                          seed=5)
    assert kept_share(keep, lay, 256) < 0.45


def test_cut_with_atoms_at_the_reach_edge():
    """Atoms right above a voxel center at exactly R + probe (d2 equals the
    threshold there) must be kept; atoms at the cut's own limit, just
    inside and just outside it, on both sides of a slab and across the
    periodic z boundary, are kept or dropped by the rule and change no
    mask."""
    box, gz, probe = 16.0, 32, 1.25
    frac, radii = background(6, 240, dyadic=True)
    hz, mu = gk._z_cut_geometry(torch.eye(3) * box)
    edge, edge_r = [], []
    for fx, fy in [(0.53125, 0.28125), (0.21875, 0.84375),
                   (0.78125, 0.59375), (0.03125, 0.03125)]:
        rad = 1.5
        reach = (rad + probe) / box  # 0.171875: exact
        lim = (rad + probe + mu) / hz
        # slab 0: voxel centers 0.5/32 .. 7.5/32
        edge += [(fx, fy, 7.5 / gz + reach),          # d2 == threshold
                 (fx, fy, (0.5 / gz - reach) % 1.0),  # below z = 0
                 (fx, fy, 8 / gz + lim - 1e-6),       # just inside the cut
                 (fx, fy, 8 / gz + lim + 2e-6)]       # past lim + 2^-20
        edge_r += [rad] * 4
    frac = np.concatenate([frac, np.array(edge, np.float32)])
    radii = np.concatenate([radii, np.array(edge_r, np.float32)])
    cell = np.eye(3, dtype=np.float32) * box
    keep, lay = check_cut(frac, cell, radii, (16, 16, gz), probe, probe, 256)
    # where the reach-edge atoms ended up, and what slab 0 kept of them
    n_bg = len(frac) - len(edge)
    (fx, fy, fz, _), ok = gk._gather_runs(lay.payload, lay.start, lay.count,
                                          256)
    for i, (ex, ey, ez) in enumerate(edge):
        hit = ok & (fx == np.float32(ex)) & (fy == np.float32(ey)) \
            & (fz == np.float32(ez))
        assert bool(hit.any()), f"edge atom {n_bg + i} not a candidate"
        kept = keep[:, 0][hit]
        if i % 4 in (0, 1):
            assert bool(kept.all()), "an atom within reach was dropped"
        if i % 4 == 2:
            assert bool(kept.all()), "the cut's inside limit was dropped"
        if i % 4 == 3:
            assert not bool(kept.any()), "the cut kept a row past its limit"


def test_cut_on_a_missed_run():
    """Runs cut at ``window`` rows: the kept rows come from the truncated
    runs only, as the full plain version reads them."""
    frac, radii = background(7, 400, squeeze=0.72, dyadic=True)
    cell = np.eye(3, dtype=np.float32) * 16.0
    keep, lay = check_cut(frac, cell, radii, (16, 16, 40), 1.25, 1.25, 24)
    assert bool(lay.missed)
    assert bool((keep.sum(dim=2) <= 3 * 24).all())


def test_a_degenerate_cell_keeps_every_row():
    """h_z = 0: nothing is provably out of reach, so nothing is dropped."""
    frac, radii = background(8, 200)
    f, r = torch.from_numpy(frac), torch.from_numpy(radii)
    lay = gk.masks_layout(f, r, NB, NB, 256)
    cell = torch.tensor([[16.0, 0, 0], [0, 16.0, 0], [4.0, 4.0, 0]])
    keep = gk.void_masks_z_window(lay, cell, (16, 16, 16), NB, NB, 256, 1.2)
    _, ok = gk._gather_runs(lay.payload, lay.start, lay.count, 256)
    assert torch.equal(keep, ok[:, None, :].expand_as(keep))
