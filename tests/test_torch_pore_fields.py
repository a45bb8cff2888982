"""Parity of the port's per-frame pore geometry (``pore/grid_kernel.py``,
run on the CPU) with ``amof_tpu``'s on the same numpy inputs: the three
distance fields (full, one-level and two-level sorted window) and the MC
point field with their miss flags; ``face_label_pairs``, ``dilate`` and
``percolating_flags``; both surface-point classifications;
``covering_volume_counts``; ``ray_chord_lengths``.

Systems: at most 320 atoms in a 16 A cell on a 32 x 32 x 16 voxel grid,
so voxel centres are dyadic. Cubic cells take positions on a 1/1024
fractional grid; the sheared cell takes a 1/64 grid and shears of 2, -1
and 1 A, so every offset, product and squared norm is exact in float32
(XLA:CPU contracts the reference's multiply-adds into FMAs, which would
otherwise move the last bit).

Tolerances: fields, flags, masks, labels, covering counts and surface
counts exact (the Fibonacci directions are not dyadic, yet every case
here agrees point for point: no sample point lies within rounding of a
blocker sphere or a voxel face). Ray chords rtol
1e-5: the start points and directions are random floats, so the
reference's FMAs move the march by rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu_torch.pore import grid_kernel as gk

torch.set_num_threads(2)

GRID = (32, 32, 16)
BOX = 16.0


def system(n=320, sheared=False, seed=5, squeeze=0.72):
    """(frac f32 [n, 3], cell f32 [3, 3], radii f32 [n]): dyadic
    positions (z squeezed, which leaves a void slab) in a 16 A cell."""
    rng = np.random.default_rng(seed)
    frac = rng.random((n, 3))
    frac[:, 2] *= squeeze
    step = 64 if sheared else 1024
    frac = (np.round(frac * step) / step).astype(np.float32)
    cell = np.eye(3) * BOX
    if sheared:
        cell[1, 0], cell[2, 0], cell[2, 1] = 2.0, -1.0, 1.0
    radii = np.where(np.arange(n) % 3 == 0, 1.5, 1.0).astype(np.float32)
    return frac, cell.astype(np.float32), radii


def pair(*arrays):
    """The same arrays as jax and torch inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def assert_same(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("sheared", [False, True])
def test_distance_grid_equal(sheared):
    (jf, jc, jr), (tf, tc, tr) = pair(*system(sheared=sheared))
    got = gk.distance_grid(tf, tc, tr, GRID)
    assert got.shape == GRID and got.dtype == torch.float32
    assert_same(got, jgk.distance_grid(jf, jc, jr, GRID))


@pytest.mark.parametrize("sheared", [False, True])
@pytest.mark.parametrize("chunk,window", [(256, 192), (512, 256),
                                          (1024, 96), (256, 319)])
def test_distance_grid_windowed_equal(sheared, chunk, window):
    """The miss flag always; the clamped field where nothing misses (the
    port takes each x plane's own reach, the reference each chunk's
    window, which agree below dmax)."""
    (jf, jc, jr), (tf, tc, tr) = pair(*system(sheared=sheared))
    kw = dict(dmax=1.201, dxa=0.2, chunk=chunk, window=window)
    ref, r_miss = jgk.distance_grid_windowed(jf, jc, jr, GRID, **kw)
    got, g_miss = gk.distance_grid_windowed(tf, tc, tr, GRID, **kw)
    assert bool(g_miss) == bool(r_miss)
    if not bool(r_miss):
        assert_same(got, ref)
    assert (window < 150) == bool(g_miss)


def test_distance_grid_windowed_reach_spanning_the_cell():
    (jf, jc, jr), (tf, tc, tr) = pair(*system(n=200))
    kw = dict(dmax=2.5, dxa=0.49, chunk=1024, window=150)
    ref, r_miss = jgk.distance_grid_windowed(jf, jc, jr, GRID, **kw)
    got, g_miss = gk.distance_grid_windowed(tf, tc, tr, GRID, **kw)
    assert not bool(g_miss) and not bool(r_miss)
    assert_same(got, ref)


@pytest.mark.parametrize("sheared", [False, True])
@pytest.mark.parametrize("tvx,tvy,nbx,k_slabs,window", [
    (4, 8, 4, 3, 128), (8, 16, 5, 4, 96), (4, 4, 8, 5, 48),
    (4, 8, 4, 3, 40)])
def test_distance_grid_windowed2_equal(sheared, tvx, tvy, nbx, k_slabs,
                                       window):
    (jf, jc, jr), (tf, tc, tr) = pair(*system(sheared=sheared))
    kw = dict(dmax=1.201, dxa=0.17, dya=0.17, tvx=tvx, tvy=tvy, nbx=nbx,
              k_slabs=k_slabs, window=window)
    ref, r_miss = jgk.distance_grid_windowed2(jf, jc, jr, GRID, **kw)
    got, g_miss = gk.distance_grid_windowed2(tf, tc, tr, GRID, **kw)
    assert bool(g_miss) == bool(r_miss)
    assert_same(got, ref)


def mc_points(m=2048, chunk=256, seed=9):
    """x-sorted dyadic sample points and their per-chunk x bounds."""
    pts = np.random.default_rng(seed).random((m, 3))
    pts = (np.round(pts * 1024) / 1024).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    return (pts, np.ascontiguousarray(pts[::chunk, 0]),
            np.ascontiguousarray(pts[chunk - 1::chunk, 0]))


@pytest.mark.parametrize("sheared", [False, True])
@pytest.mark.parametrize("window,misses", [(96, True), (160, True),
                                           (320, False)])
def test_point_distance_windowed_equal(sheared, window, misses):
    frac, cell, radii = system(sheared=sheared)
    pts, lo, hi = mc_points()
    (j_in, t_in) = pair(frac, cell, radii, pts, lo, hi)
    kw = dict(dmax=1.201, dxa=0.2, chunk=256, window=window)
    ref, r_miss = jgk.point_distance_windowed(*j_in, **kw)
    got, g_miss = gk.point_distance_windowed(*t_in, **kw)
    assert bool(g_miss) == bool(r_miss)
    assert bool(g_miss) == misses
    assert_same(got, ref)


def classified(sheared=False, n=320):
    """Frame inputs and the face-test classification at a 1.2 A probe
    (numpy)."""
    frac, cell, radii = system(n=n, sheared=sheared)
    d = np.array(jgk.distance_grid(*pair(frac, cell, radii)[0], GRID))
    _, acc, poc = (np.array(a) for a in
                   jgk.void_classification(jnp.asarray(d), 1.2))
    return frac, cell, radii, d, acc, poc


def test_void_slab_has_accessible_and_pocket_voxels():
    *_, acc, poc = classified()
    assert acc.sum() > 500 and poc.sum() > 0


@pytest.mark.parametrize("sheared", [False, True])
def test_void_classification_and_faces_equal(sheared):
    d = classified(sheared)[3]
    ref = jgk.void_classification(jnp.asarray(d), 1.2, return_faces=True)
    got = gk.void_classification(torch.from_numpy(np.array(d)), 1.2,
                                 return_faces=True)
    for g, r in zip(got, ref):
        assert_same(g, r)
    assert got[3].shape == (2, sum(GRID[i] * GRID[j] for i, j in
                                   ((1, 2), (0, 2), (0, 1))))


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_dilate_equal(steps):
    mask = np.random.default_rng(steps).random((9, 13, 7)) < 0.05
    assert_same(gk.dilate(torch.from_numpy(mask), steps),
                jgk.dilate(jnp.asarray(mask), steps))


@pytest.mark.parametrize("shape,frac", [((9, 13, 7), 0.55),
                                        ((16, 12, 20), 0.35),
                                        ((24, 24, 24), 0.3)])
def test_percolating_flags_equal(shape, frac):
    mask = np.random.default_rng(sum(shape)).random(shape) < frac
    labels = np.array(jgk.label_components(jnp.asarray(mask),
                                           periodic=False))
    ref = jgk.percolating_flags(jnp.asarray(labels), jnp.asarray(mask))
    got = gk.percolating_flags(torch.from_numpy(labels),
                               torch.from_numpy(mask))
    assert_same(got, ref)
    assert got.any() == (frac > 0.32)


@pytest.mark.parametrize("sheared", [False, True])
@pytest.mark.parametrize("k", [8, 50])
def test_surface_point_classification_equal(sheared, k):
    frac, cell, radii, _, acc, poc = classified(sheared)
    dirs = jgk.fibonacci_sphere(k)
    j_in, t_in = pair(frac, cell, radii)
    ref = jgk.surface_point_classification(
        *j_in, 1.2, jnp.asarray(dirs), jnp.asarray(acc), jnp.asarray(poc),
        GRID, chunk=32)
    got = gk.surface_point_classification(
        *t_in, 1.2, torch.from_numpy(dirs), torch.from_numpy(acc),
        torch.from_numpy(poc), GRID)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        assert_same(g, r)
    assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0


@pytest.mark.parametrize("n,window,misses", [(320, 128, False),
                                             (300, 128, False),
                                             (320, 96, True),
                                             (300, 48, True)])
def test_surface_point_classification_windowed_equal(n, window, misses):
    """Counts, order and the miss flag; 300 atoms leave a partial last
    chunk, whose candidate window ``amof_tpu`` shifts back."""
    frac, cell, radii, _, acc, poc = classified(n=n)
    dirs = jgk.fibonacci_sphere(16)
    j_in, t_in = pair(frac, cell, radii)
    ref = jgk.surface_point_classification_windowed(
        *j_in, 1.2, jnp.asarray(dirs), jnp.asarray(acc), jnp.asarray(poc),
        GRID, window=window)
    got = gk.surface_point_classification_windowed(
        *t_in, 1.2, torch.from_numpy(dirs), torch.from_numpy(acc),
        torch.from_numpy(poc), GRID, window=window)
    for g, r in zip(got, ref):
        assert_same(g, r)
    assert bool(got[4]) == misses


@pytest.mark.parametrize("sheared", [False, True])
def test_covering_volume_counts_equal(sheared):
    frac, cell, radii, d, acc, poc = classified(sheared)
    levels = (0.05 * np.arange(48)).astype(np.float32)
    ref = np.asarray(jgk.covering_volume_counts(
        jnp.asarray(d), jnp.asarray(acc), jnp.asarray(acc | poc),
        jnp.asarray(cell), levels, GRID))
    got = gk.covering_volume_counts(
        torch.from_numpy(d), torch.from_numpy(acc),
        torch.from_numpy(acc | poc), torch.from_numpy(cell), levels, GRID)
    assert_same(got, ref)
    assert ref[0] > ref[-1] > 0


@pytest.mark.parametrize("sheared", [False, True])
@pytest.mark.parametrize("r_probe", [0.0, 1.2])
def test_ray_chord_lengths_close(sheared, r_probe):
    frac, cell, radii, d, acc, _ = classified(sheared)
    rng = np.random.default_rng(12345)
    idx = np.argwhere(acc)[rng.integers(0, int(acc.sum()), 500)]
    pts = ((idx + rng.random((500, 3))) / np.array(GRID)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    j_in, t_in = pair(d, pts, dirs, cell)
    ref = np.asarray(jgk.ray_chord_lengths(*j_in, r_probe, GRID))
    got = gk.ray_chord_lengths(*t_in, r_probe, GRID).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert ref.max() > 1.0 and (ref == 100.0).sum() < 500
