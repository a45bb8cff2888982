"""Parity of the port's void-mask pass (kernel #5's plain version, run by
``surface_kernel.void_masks_points`` on CPU tensors) and of its host
planning with the JAX package: ``void_masks_points_pallas`` in interpret
mode and the XLA column pass ``void_masks_columns``, on the same numpy
inputs.

Tolerances:
  * cubic power-of-two cells with positions on a 1/512 fractional grid and
    dyadic radii: every product and sum of the factorized quadratic is
    exact in float32, so masks, point fits and the missed flag must be
    equal (XLA:CPU's FMA contraction cannot change an exact result);
  * a generic triclinic cell: XLA:CPU contracts multiply-adds into FMAs
    and the port does not, so a voxel whose squared distance to a blocker
    lies within float32 rounding of its threshold may differ. The test
    allows at most 0.05% of the voxels to differ and checks, in float64,
    that each differing voxel has a blocker with |d^2 - (R + t)^2| below
    64 float32 ulps of the threshold;
  * the plans (``xycol_plan``, ``surface_plan``,
    ``assign_points_to_xytiles``) are numpy copies: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amof_tpu.pore import grid_kernel as jgk
from amof_tpu.pore.surface_kernel import void_masks_points_pallas
from amof_tpu_torch.pore import grid_kernel, surface_kernel

torch.set_num_threads(2)

GRID = (16, 16, 16)
NB = 4


def dyadic_system(seed, n=300, box=16.0):
    rng = np.random.default_rng(seed)
    frac = np.round(rng.random((n, 3)) * 512) / 512
    frac[:, 2] = np.round(frac[:, 2] * 0.72 * 512) / 512  # void slab
    frac = (frac % 1.0).astype(np.float32)
    cell = np.eye(3, dtype=np.float32) * box
    radii = rng.choice([1.25, 1.5, 1.75], n).astype(np.float32)
    return frac, cell, radii


def triclinic_system(seed, n=260):
    rng = np.random.default_rng(seed)
    cell = np.array([[16.0, 0, 0], [1.4, 15.4, 0], [-0.9, 1.1, 15.8]],
                    np.float32)
    frac = rng.random((n, 3)).astype(np.float32)
    frac[:, 2] *= 0.7
    radii = rng.uniform(1.1, 1.8, n).astype(np.float32)
    return frac, cell, radii


def mc_points(seed, n=3000):
    pts = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    return grid_kernel.assign_points_to_xytiles(pts, {"nbx": NB, "nby": NB})


def port(frac, cell, radii, probe, chan, window, pts_tiled):
    pts = None if pts_tiled is None else torch.from_numpy(pts_tiled)
    out = surface_kernel.void_masks_points(
        torch.from_numpy(frac), torch.from_numpy(cell),
        torch.from_numpy(radii), GRID, probe, chan, NB, NB, window, pts)
    return [None if o is None else o.numpy() for o in out]


def jax_xla(frac, cell, radii, probe, chan, window, pts_tiled):
    pts = None if pts_tiled is None else jnp.asarray(pts_tiled)
    out = jgk.void_masks_columns(
        jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), GRID,
        probe=probe, chan=chan, nbx=NB, nby=NB, window=window,
        pts_tiled=pts)
    return [None if o is None else np.asarray(o) for o in out]


def jax_pallas(frac, cell, radii, probe, chan, window, pts_tiled):
    pts = None if pts_tiled is None else jnp.asarray(pts_tiled)
    out = void_masks_points_pallas(
        jnp.asarray(frac), jnp.asarray(cell), jnp.asarray(radii), GRID,
        probe=probe, chan=chan, nbx=NB, nby=NB, window=window,
        pts_tiled=pts, interpret=True)
    return [None if o is None else np.asarray(o) for o in out]


def min_margin(points_frac, frac, cell, radii, thr):
    """float64 min over atoms (all 27 images) of d^2 - (R + thr)^2 at
    each fractional point, relative to the threshold."""
    img = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)], np.float64)
    cell64 = cell.astype(np.float64)
    out = []
    for p in points_frac:
        df = p[None, :] - frac.astype(np.float64)
        df -= np.round(df)
        d = (df[:, None, :] + img[None]) @ cell64  # [N, 27, 3]
        d2 = (d * d).sum(-1).min(axis=1)
        th = (radii.astype(np.float64) + thr) ** 2
        out.append(np.min(np.abs(d2 - th) / th))
    return np.array(out)


@pytest.mark.parametrize("seed,probe,chan", [(0, 1.25, 1.25),
                                             (5, 1.0, 1.25),
                                             (6, 1.5, 1.0)])
@pytest.mark.parametrize("with_pts", [True, False])
def test_dyadic_cubic_masks_equal(seed, probe, chan, with_pts):
    frac, cell, radii = dyadic_system(seed)
    pts_tiled, w = mc_points(seed) if with_pts else (None, None)
    got = port(frac, cell, radii, probe, chan, 256, pts_tiled)
    for ref in (jax_xla(frac, cell, radii, probe, chan, 256, pts_tiled),
                jax_pallas(frac, cell, radii, probe, chan, 256, pts_tiled)):
        assert bool(got[3]) == bool(ref[3]) is False
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        if with_pts:
            real = w > 0
            np.testing.assert_array_equal(got[2][real], ref[2][real])
        else:
            assert got[2] is None and ref[2] is None
    assert 0 < got[1].sum() < got[1].size  # non-degenerate


def test_missed_flag_on_a_small_window():
    frac, cell, radii = dyadic_system(2)
    for window in (24, 256):
        got = port(frac, cell, radii, 1.25, 1.25, window, None)
        ref = jax_xla(frac, cell, radii, 1.25, 1.25, window, None)
        assert bool(got[3]) == bool(ref[3]) == (window == 24)


@pytest.mark.parametrize("with_pts", [True, False])
def test_triclinic_masks_differ_only_on_borderline_voxels(with_pts):
    frac, cell, radii = triclinic_system(3)
    pts_tiled, w = mc_points(4) if with_pts else (None, None)
    got = port(frac, cell, radii, 1.2, 1.2, 256, pts_tiled)
    ref = jax_xla(frac, cell, radii, 1.2, 1.2, 256, pts_tiled)
    assert bool(got[3]) == bool(ref[3]) is False
    diff = np.argwhere(got[1] != ref[1])
    assert len(diff) <= 5e-4 * got[1].size
    centers = (diff + 0.5) / np.array(GRID)
    margin = min_margin(centers, frac, cell, radii, 1.2)
    assert np.all(margin < 64 * 2.0**-23), margin
    np.testing.assert_array_equal(got[0] != ref[0], got[1] != ref[1])
    if with_pts:
        real = w > 0
        bad = np.argwhere(real & (got[2] != ref[2]))
        assert len(bad) <= 5e-4 * real.sum()
        margin = min_margin(pts_tiled[bad[:, 0], bad[:, 1]], frac, cell,
                            radii, 1.2)
        assert np.all(margin < 64 * 2.0**-23), margin


def test_plans_and_point_tiles_equal():
    rng = np.random.default_rng(7)
    cells = np.stack([np.eye(3) * 54.87, np.eye(3) * 55.3])
    cells[1, 1, 0] = 1.5
    for args in ((cells, 1.7, 1.201, (112, 112, 112), 10240),
                 (cells[:1], 1.5, 1.001, (64, 60, 64), 2048),
                 (np.eye(3) * 12.0, 1.7, 1.201, (48, 48, 48), 300)):
        assert grid_kernel.xycol_plan(*args) == jgk.xycol_plan(*args)
    for args in ((cells, 1.7, 1.2, 10240), (cells[:1], 1.5, 1.0, 2048),
                 (np.eye(3) * 12.0, 1.7, 1.2, 300)):
        assert grid_kernel.surface_plan(*args) == jgk.surface_plan(*args)
    plan = grid_kernel.xycol_plan(cells, 1.7, 1.201, (112, 112, 112), 10240)
    assert (plan["grid"], plan["nbx"], plan["window"]) == \
        ((112, 112, 112), 16, 224)
    pts = rng.random((50000, 3)).astype(np.float32)
    for a, b in zip(grid_kernel.assign_points_to_xytiles(pts, plan),
                    jgk.assign_points_to_xytiles(pts, plan)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grid_kernel.fibonacci_sphere(8),
                                  jgk.fibonacci_sphere(8))
