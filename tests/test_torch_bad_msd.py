"""Parity of the port's BAD histograms and MSD series with the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
  * BAD: the total angle count is exact (the neighbour sets are exact,
    see test_torch_neighbors); a single angle may move by at most one
    bin, because ``arccos`` is not correctly rounded in either package
    (and XLA:CPU contracts the dot product into FMAs). Checked as: equal
    totals, and the per-bin difference, accumulated from the low end,
    never exceeds the counts of the two bins involved.
  * MSD: rtol 1e-4 (float32 FFT round-off; the two FFT libraries sum in
    different orders); the per-atom series also allows 8 float32 ulps of
    the per-atom sum Q = sum_k |r_k|^2, the size of the terms that cancel
    in S(m) = S1(m) - 2 AC(m).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amof_tpu.ops import bad_kernel as jax_bad
from amof_tpu.ops import msd_kernel as jax_msd
from amof_tpu.ops import slab_table as jax_slab
from amof_tpu_torch.ops import bad_kernel, msd_kernel, slab_table

from test_torch_rdf import grid_case, t

torch.set_num_threads(2)

CUTOFF = np.array([[0.0, 2.1, 2.0], [2.1, 0.0, 1.9], [2.0, 1.9, 1.6]],
                  np.float32)


def assert_bins_within_one(got, ref):
    """Equal totals per histogram row, and ``got`` turns into ``ref`` by
    moving each angle at most one bin: along every row the running sum of
    (got - ref) is bounded by the neighbouring bins' counts."""
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    np.testing.assert_array_equal(got.sum(axis=1), ref.sum(axis=1))
    flow = np.cumsum(got - ref, axis=1)  # angles that crossed edge k|k+1
    cap = (np.maximum(got[:, :-1], ref[:, :-1])
           + np.maximum(got[:, 1:], ref[:, 1:]))
    assert np.all(np.abs(flow[:, :-1]) <= cap)
    assert np.abs(got - ref).sum() <= 0.01 * ref.sum() + 4


@pytest.mark.parametrize("rung", ["slab", "window", "full"])
def test_frame_bad_counts_match_jax(rung):
    pos, cell, sp = grid_case(2048, 3, 21, box=32.0, pad_from=2030)
    dtheta, bins = 0.5, int(180 // 0.5) + 1
    ref_c, ref_a, ref_f, ref_cn = jax_bad.frame_bad_counts(
        jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(sp),
        jnp.asarray(CUTOFF), 3, dtheta, bins, max_neighbors=12, chunk=128,
        window=384, emit_cn=True,
    )
    slab = None
    if rung == "slab":
        slab = slab_table.slab_plan(cell, float(CUTOFF.max()), 2048,
                                    positions=pos[None], species_idx=sp)
        assert slab is not None
    got_c, got_a, got_f, got_cn = bad_kernel.frame_bad_counts(
        t(pos), t(cell), t(sp), t(CUTOFF), 3, dtheta, bins,
        max_neighbors=12, chunk=128,
        window=None if rung == "full" else 384, emit_cn=True, slab=slab,
    )
    assert not bool(ref_f) and not bool(got_f)
    assert got_c.shape == ref_c.shape and got_a.shape == ref_a.shape
    assert float(np.asarray(ref_a).sum()) > 1000
    np.testing.assert_array_equal(got_cn.numpy(), np.asarray(ref_cn))
    assert_bins_within_one(got_c.numpy(), ref_c)
    assert_bins_within_one(got_a.numpy(), ref_a)


def test_overflow_flag_matches_jax():
    pos, cell, sp = grid_case(2048, 3, 22, box=32.0)
    args = (3, 1.0, 181)
    _, _, ref_f = jax_bad.frame_bad_counts(
        jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(sp),
        jnp.asarray(CUTOFF), *args, max_neighbors=2, chunk=128, window=384)
    _, _, got_f = bad_kernel.frame_bad_counts(
        t(pos), t(cell), t(sp), t(CUTOFF), *args, max_neighbors=2,
        chunk=128, window=384)
    assert bool(ref_f) and bool(got_f)


@pytest.mark.parametrize("window, k, missed", [
    (16, 24, True),     # window too narrow: a miss, whatever K
    (384, 2, False),    # window covers: the flag is K overflow alone
    (None, 2, False),   # full table: never a miss
])
def test_emit_missed_tells_a_window_miss_from_an_overflow(window, k, missed):
    """The rerun ladder moves a frame to the full table on a window miss
    only; the miss must come back apart from the overflow flag."""
    pos, cell, sp = grid_case(2048, 3, 22, box=32.0)
    got = bad_kernel.frame_bad_counts(
        t(pos), t(cell), t(sp), t(CUTOFF), 3, 1.0, 181, max_neighbors=k,
        chunk=128, window=window, emit_cn=True, emit_missed=True)
    assert len(got) == 5
    assert bool(got[2])  # flagged either way
    assert bool(got[4]) == missed


@pytest.mark.parametrize("spec",[(0, 1), (2, -1), (-1, -1)])
def test_select_spec_counts(spec):
    rng = np.random.default_rng(23)
    conc = rng.integers(0, 9, (3, 3, 1, 20)).astype(np.float64)
    anyc = rng.integers(0, 9, (3, 1, 20)).astype(np.float64)
    np.testing.assert_array_equal(
        bad_kernel.select_spec_counts(conc, anyc, spec),
        np.asarray(jax_bad.select_spec_counts(conc, anyc, spec)))


def _walk(n_frames, n_atoms, seed, box=16.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, box, (1, n_atoms, 3))
    x = base + np.cumsum(rng.normal(0, 0.3, (n_frames, n_atoms, 3)), axis=0)
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    return (x % box).astype(np.float32), cells


@pytest.mark.parametrize("policy", ["amof", "standard"])
def test_windowed_msd_series_matches_jax(policy):
    x, _ = _walk(64, 40, 24)
    x = np.cumsum(np.diff(x, axis=0, prepend=x[:1]), axis=0)  # unwrapped
    ref = np.asarray(jax_msd.windowed_msd_atom_series(x, policy))
    got = msd_kernel.windowed_msd_atom_series(t(x), policy).numpy()
    # S(m) = S1(m) - 2 AC(m) cancels terms of size Q = sum_k |r_k|^2, so
    # besides rtol 1e-4 an element may differ by a few float32 ulps of Q
    q = (x.astype(np.float64) ** 2).sum(axis=(0, 2))
    assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref) + 8 * 2.0**-23 * q)


def test_unwrap_and_com_match_jax():
    x, cells = _walk(32, 50, 25)
    cells[:, 0, 1] = 1.5  # triclinic
    ref = np.asarray(jax_msd.unwrap_positions(x, cells))
    got = msd_kernel.unwrap_positions(t(x), t(cells)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    masses = np.random.default_rng(26).uniform(1, 60, 50).astype(np.float32)
    np.testing.assert_allclose(
        msd_kernel.remove_com_drift(t(got), t(masses)).numpy(),
        np.asarray(jax_msd.remove_com_drift(ref, masses)),
        rtol=1e-5, atol=1e-4)


def test_slab_layout_misses_like_jax_when_capacity_is_short():
    """A plan sized for a dilute frame flags a clumped one (both
    packages), so the caller falls back instead of dropping angles."""
    pos, cell, sp = grid_case(2048, 3, 27, box=32.0)
    plan = jax_slab.slab_plan(cell, 2.1, 2048, positions=pos[None])
    clumped = pos.copy()
    clumped[:600, 0] = np.float32(0.5)  # one x-slab holds 600 atoms
    ref = jax_slab.build_slab_layout(jnp.asarray(clumped), jnp.asarray(sp),
                                     jnp.asarray(cell), plan)
    got = slab_table.build_slab_layout(t(clumped), t(sp), t(cell),
                                       slab_table.SlabPlan(*plan))
    assert bool(ref[4]) and bool(got[4])
