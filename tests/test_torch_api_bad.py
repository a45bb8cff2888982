"""Parity of the port's ``Bad`` and ``BadByCn`` (``from_trajectory``, the
retry ladder, the coordination-number axis, 'total'/'partial'
normalization, the file round-trips) and ``CoreBad.bad_BAB`` with
``amof_tpu``'s classes on the CPU, on the same numpy trajectories.

Tolerances:
  * BAD densities: each spec's angle total is exact and an angle may move
    at most one bin (``arccos`` is not correctly rounded in either
    package; test_torch_bad_msd), checked on the counts recovered from
    the densities;
  * BadByCn: exact, values and coordinates (``cn`` included).

The ladder test starts the port's first pass at K 8: every frame runs
once on the 2-level slab table (kernel #3's plain version), then only the
crowded frame reruns up the shared ladder on the 1-level window (#4's)
at K 16 and 32; ``amof_tpu`` reruns the whole trajectory from K 16
without the slab. Histograms are order-invariant, so the results must
agree.

The first pass runs each frame through its frame graph's body (eager on
the CPU); its counts, with and without the ladder started at K 8, equal
those of the frame-by-frame loop it replaced bit for bit
(``test_torch_fused_graph.eager_bad_counts``).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import amof_tpu.bad as jbad
import amof_tpu_torch.bad as tbad
from amof_tpu_torch import tracing
from amof_tpu_torch.ops import bad_kernel, frame_table

from test_torch_api_rdf import batches
from test_torch_bad_msd import assert_bins_within_one
from test_torch_fused_graph import counted, eager_bad_counts
from test_torch_pipeline import CUTOFFS, glass

torch.set_num_threads(2)

DTHETA = 1.0


def crowded(n_crowd=20):
    """Two frames of the 2048-atom glass; in frame 1, ``n_crowd`` N atoms
    sit 1.0-1.8 A from the first Zn, which then has more than 16
    neighbours (the ladder must reach K 32)."""
    pos, cells, species = glass(n_frames=2, n_atoms=2048)
    rng = np.random.default_rng(12)
    off = rng.normal(0, 1, (n_crowd, 3))
    off *= (rng.uniform(1.0, 1.8, n_crowd) / np.linalg.norm(off, axis=1))[:,
                                                                          None]
    n_zn = int((species == 30).sum())
    pos[1, n_zn:n_zn + n_crowd] = np.round(
        ((pos[1, 0] + off) % 32.0) * 32) / 32
    return pos, cells, species


@pytest.fixture(scope="module")
def traj():
    return crowded()


@pytest.fixture(scope="module")
def ref(traj):
    _, jb = batches(*traj)
    return {
        "bad": jbad.Bad.from_trajectory(jb, CUTOFFS, dtheta=DTHETA).data,
        "total": jbad.BadByCn.from_trajectory(jb, CUTOFFS, dtheta=DTHETA)
        .data["bad"],
        "partial": jbad.BadByCn.from_trajectory(
            jb, CUTOFFS, dtheta=DTHETA, normalization="partial").data["bad"],
    }


def assert_densities_close(got, ref_df, batch):
    """Equal columns; each spec's counts (density x total x dtheta, with
    the total from the port's own counts) within one-bin moves."""
    assert list(got.columns) == list(ref_df.columns)
    np.testing.assert_array_equal(got["theta"], ref_df["theta"])
    counts, names, _ = tbad._compute_counts(batch, CUTOFFS, DTHETA,
                                            device="cpu")
    totals = dict(zip(names, counts.sum(axis=(1, 2))))
    for name in got.columns[1:]:
        scale = totals[name] * DTHETA
        assert_bins_within_one(
            np.round(got[name].to_numpy() * scale)[None],
            np.round(ref_df[name].to_numpy() * scale)[None])


def assert_labeled_equal(got, ref_arr):
    assert got.dims == ref_arr.dims == ("atom_triple", "cn", "theta")
    for dim in got.dims:
        np.testing.assert_array_equal(got.coords[dim], ref_arr.coords[dim])
    np.testing.assert_array_equal(got.values, ref_arr.values)


@pytest.fixture
def ladder(monkeypatch, traj):
    """Start the first pass at K 8; log each frame pass's (frame, K,
    rung)."""
    passes = []
    fn = frame_table.frame_pass
    rows = torch.from_numpy(traj[0])

    def logged(plan, pos, *a, **k):
        # pos holds row f of the trajectory's [F, N, 3] positions (the
        # first pass reads a copy of it)
        f = next(f for f, row in enumerate(rows)
                 if torch.equal(pos[:len(row)], row))
        passes.append((f, a[4], a[5]))
        return fn(plan, pos, *a, **k)

    monkeypatch.setattr(frame_table, "FIRST_CAPACITY", 8)
    monkeypatch.setattr(frame_table, "frame_pass", logged)
    return passes


@pytest.mark.parametrize("forced_ladder", [False, True])
def test_bad_matches_amof_tpu(traj, ref, forced_ladder, request):
    rungs = request.getfixturevalue("ladder") if forced_ladder else None
    batch, _ = batches(*traj)
    got = tbad.Bad.from_trajectory(batch, CUTOFFS, dtheta=DTHETA,
                                   device="cpu")
    if forced_ladder:
        # the first pass over every frame, then reruns of only the crowded
        # frame
        assert rungs == [(0, 8, "slab"), (1, 8, "slab"), (1, 16, "window"),
                         (1, 32, "window")]
    assert_densities_close(got.data, ref["bad"], batch)


@pytest.mark.parametrize("normalization", ["total", "partial"])
@pytest.mark.parametrize("forced_ladder", [False, True])
def test_bad_by_cn_matches_amof_tpu(traj, ref, normalization, forced_ladder,
                                    request):
    if forced_ladder:
        request.getfixturevalue("ladder")
    batch, _ = batches(*traj)
    got = tbad.BadByCn.from_trajectory(batch, CUTOFFS, dtheta=DTHETA,
                                       normalization=normalization,
                                       device="cpu").data["bad"]
    assert_labeled_equal(got, ref[normalization])
    assert got.coords["cn"].max() > 16  # the crowded Zn's X-Zn-X row


@pytest.mark.parametrize("by_cn", [False, True])
@pytest.mark.parametrize("forced_ladder", [False, True])
def test_first_pass_body_equals_eager_loop(traj, by_cn, forced_ladder,
                                           request, monkeypatch):
    """The first pass through its frame graph's body (the CPU runs it
    eagerly, on copies of each frame's inputs) gives the counts of the
    frame-by-frame loop bit for bit: the crowded frame adds nothing in
    the first pass and its rerun is kept once. So do ``bad_columns`` and
    ``bad_by_cn_dataset``. The CPU counts every first-pass frame in
    ``bad.frames`` and replays none."""
    if forced_ladder:
        request.getfixturevalue("ladder")
    batch, _ = batches(*traj)
    (counts, names, theta), moved = counted(lambda: tbad._compute_counts(
        batch, CUTOFFS, DTHETA, by_cn=by_cn, device="cpu"))
    ref = eager_bad_counts(batch, CUTOFFS, DTHETA, by_cn, "cpu")
    assert counts.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(counts, ref)
    assert counts.shape[1] == (33 if by_cn else 1)  # the rerun's K 32
    assert moved["bad.frames"] == 2
    assert "bad.frames_graphed" not in moved
    assert "bad.graph_captures" not in moved
    assert tracing.snapshot()["counts"]["bad.frames_graphed"] == 0
    if by_cn:
        public = functools.partial(tbad.bad_by_cn_dataset,
                                   normalization="partial")
    else:
        public = tbad.bad_columns
    got = public(batch, CUTOFFS, dtheta=DTHETA, device="cpu")
    monkeypatch.setattr(tbad, "_compute_counts",
                        lambda *a, **k: (ref, names, theta))
    want = public(batch, CUTOFFS, dtheta=DTHETA, device="cpu")
    if by_cn:
        assert_labeled_equal(got["bad"], want["bad"])
    else:
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_frame_by_cn_counts_match_amof_tpu():
    """The by-cn histograms of one frame on the window table, K 32."""
    import jax.numpy as jnp

    from amof_tpu.ops import bad_kernel as jax_bad
    from test_torch_rdf import grid_case, t
    from test_torch_bad_msd import CUTOFF

    pos, cell, sp = grid_case(2048, 3, 31, box=32.0, pad_from=2040)
    ref = jax_bad.frame_bad_counts(
        jnp.asarray(pos), jnp.asarray(cell), jnp.asarray(sp),
        jnp.asarray(CUTOFF), 3, 2.0, 91, max_neighbors=32, chunk=128,
        window=384, by_cn=True)
    got = bad_kernel.frame_bad_counts(
        t(pos), t(cell), t(sp), t(CUTOFF), 3, 2.0, 91, max_neighbors=32,
        chunk=128, window=384, by_cn=True)
    assert not bool(ref[2]) and not bool(got[2])
    assert got[0].shape == ref[0].shape == (3, 3, 33, 91)
    assert got[1].shape == ref[1].shape == (3, 33, 91)
    for g, r in zip(got[:2], ref[:2]):
        r = np.asarray(r)
        # exact per (species, cn) totals: the cn axis itself is exact
        np.testing.assert_array_equal(g.numpy().sum(-1), r.sum(-1))
        assert_bins_within_one(g.numpy(), r)


def test_ladder_gives_up_past_its_capacity(traj, monkeypatch):
    monkeypatch.setattr(frame_table, "FIRST_CAPACITY", 4)
    monkeypatch.setattr(frame_table, "MAX_RERUN_CAPACITY", 16)
    batch, _ = batches(*traj)
    with pytest.raises(RuntimeError, match="capacity"):
        tbad.Bad.from_trajectory(batch, CUTOFFS, dtheta=DTHETA, device="cpu")


def test_bad_round_trips(tmp_path):
    batch, _ = batches(*glass(n_frames=2, n_atoms=1024))
    bad = tbad.Bad.from_trajectory(batch, CUTOFFS, dtheta=DTHETA,
                                   device="cpu")
    bad.write_to_file(tmp_path / "plain")
    back = tbad.Bad.from_file(tmp_path / "plain.bad")
    assert list(back.data.columns) == list(bad.data.columns)
    np.testing.assert_array_equal(back.data.to_numpy(), bad.data.to_numpy())
    by_cn = tbad.BadByCn.from_trajectory(batch, CUTOFFS, dtheta=DTHETA,
                                         device="cpu")
    by_cn.write_to_file(tmp_path / "by_cn")
    back = tbad.BadByCn.from_file(tmp_path / "by_cn").data["bad"]
    assert_labeled_equal(back, by_cn.data["bad"])
    # amof_tpu reads the port's file
    assert_labeled_equal(
        jbad.BadByCn.from_file(tmp_path / "by_cn").data["bad"], back)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbad.Bad.from_trajectory(batch, CUTOFFS)


def test_bad_bab_matches_amof_tpu():
    from amof_tpu.core.frames import Frame as JaxFrame
    from amof_tpu_torch import Frame

    pos, cells, species = glass(n_frames=1, n_atoms=272, box=16.0, seed=3)
    frame = Frame(pos[0], species, cells[0])
    d = pos[0][:, None] - pos[0][None]
    d -= 16.0 * np.round(d / 16.0)
    dist = np.linalg.norm(d, axis=-1)
    nl = {i: [j for j in range(len(species)) if j != i and dist[i, j] < 2.0]
          for i in range(len(species))}
    for a, b in itertools.product([30, "X"], [7, "X"]):
        got = tbad.CoreBad.bad_BAB(frame, a, b, nl)
        ref = jbad.CoreBad.bad_BAB(JaxFrame(pos[0], species, cells[0]), a, b,
                                   nl)
        assert len(got) == len(ref) > 0
        np.testing.assert_array_equal(got, ref)
