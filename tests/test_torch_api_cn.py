"""Parity of the port's ``cn.CoordinationNumber.from_trajectory`` with
``amof_tpu``'s class on the CPU, on the same numpy trajectories, through
both of its passes: the full O(N^2) pass (below 2048 padded atoms), the
sorted-window pass (kernel #4's table, its plain version here) and the
window pass's fallback to the full pass on a frame engineered to miss
the window (all atoms in a thin x-slab of a large box, as
``tests/test_cn_bad.py`` ``TestCnWindowMissFallback``), last or in the
middle of the trajectory; the counters ``cn.frames``,
``cn.frames_windowed`` and ``cn.frames_full`` say which pass each frame
kept.

Tolerance: exact. The counts are integers and the positions sit on a
1/32 A grid in power-of-two cubic cells (see test_torch_rdf).
"""

import numpy as np
import pytest
import torch

import amof_tpu.cn as jcn
import amof_tpu_torch.cn as tcn
from amof_tpu_torch import tracing
from amof_tpu_torch.ops import pair_engine

from test_torch_api_rdf import assert_frames_equal, batches
from test_torch_cn_windowed import SLAB_CUTOFFS, slab_frames
from test_torch_pipeline import CUTOFFS, glass

torch.set_num_threads(2)


@pytest.mark.parametrize("case,passes,kept", [
    ("full", {"full": 3}, {"windowed": 0, "full": 3}),
    ("windowed", {"windowed": 3}, {"windowed": 3, "full": 0}),
    ("window_miss", {"windowed": 2, "full": 1}, {"windowed": 1, "full": 1}),
    ("window_miss_middle", {"windowed": 3, "full": 1},
     {"windowed": 2, "full": 1}),
])
def test_cn_from_trajectory_matches_amof_tpu(case, passes, kept,
                                             monkeypatch):
    """``kept``: the frames whose counts each pass gave (counters
    ``cn.frames_windowed``, ``cn.frames_full``). The middle frame of
    ``window_miss_middle`` misses, so the full pass's rerun after the
    windowed loop has to land on row 1."""
    if case == "full":
        arrays, cut = glass(n_frames=3, n_atoms=1024), CUTOFFS
    elif case == "windowed":
        arrays, cut = glass(n_frames=3, n_atoms=2048), CUTOFFS
    elif case == "window_miss":
        arrays, cut = slab_frames(), SLAB_CUTOFFS
    else:
        arrays, cut = slab_frames(3, (1,)), SLAB_CUTOFFS
    batch, jb = batches(*arrays)
    seen = {"windowed": 0, "full": 0}
    for name, key in (("frame_cn_counts_windowed", "windowed"),
                      ("frame_cn_counts", "full")):
        fn = getattr(pair_engine, name)
        monkeypatch.setattr(
            pair_engine, name,
            lambda *a, _fn=fn, _k=key, **k: seen.__setitem__(_k, seen[_k] + 1)
            or _fn(*a, **k))
    before = tracing.snapshot()
    got = tcn.CoordinationNumber.from_trajectory(batch, cut, delta_Step=5,
                                                 first_frame=10, device="cpu")
    counts = tracing.diff(tracing.snapshot(), before)["counts"]
    ref = jcn.CoordinationNumber.from_trajectory(jb, cut, delta_Step=5,
                                                 first_frame=10)
    assert {k: v for k, v in seen.items() if v} == passes
    assert counts.get("cn.frames") == len(arrays[0])
    assert {k: counts.get("cn.frames_" + k, 0) for k in kept} == kept
    assert counts.get("cn.frames_full", 0) == seen["full"]
    assert_frames_equal(got.data, ref.data)
    assert list(got.data["Step"]) == list(range(10, 10 + 5 * len(got.data),
                                                 5))
    assert (got.data.iloc[:, 1:].to_numpy() > 0).all()


def test_window_miss_is_flagged_and_counts_fall_back():
    """The frame on the thin slab misses; the uniform one does not, and
    its windowed counts equal the full pass's."""
    pos, cells, species = slab_frames()
    sp = np.searchsorted(np.unique(species), species).astype(np.int32)
    cut = torch.tensor([[0.0, 2.8], [2.8, 2.2]])
    out = []
    for f in range(2):
        args = (torch.from_numpy(pos[f]), torch.from_numpy(cells[f]),
                torch.from_numpy(sp), cut, 2)
        out.append((pair_engine.frame_cn_counts_windowed(*args, 256, 256),
                    pair_engine.frame_cn_counts(*args, 256)))
    (cn0, missed0), full0 = out[0]
    (_, missed1), _ = out[1]
    assert not bool(missed0) and bool(missed1)
    assert torch.equal(cn0, full0)


def test_cn_round_trip_and_default_device(tmp_path):
    batch, _ = batches(*glass(n_frames=2, n_atoms=1024))
    cn = tcn.CoordinationNumber.from_trajectory(batch, CUTOFFS, device="cpu")
    cn.write_to_file(tmp_path / "out")
    assert_frames_equal(tcn.CoordinationNumber.from_file(
        tmp_path / "out.cn").data, cn.data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcn.CoordinationNumber.from_trajectory(batch, CUTOFFS)
