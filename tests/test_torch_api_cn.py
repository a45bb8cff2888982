"""Parity of the port's ``cn.CoordinationNumber.from_trajectory`` with
``amof_tpu``'s class on the CPU, on the same numpy trajectories, through
both of its passes: the full O(N^2) pass (below 2048 padded atoms), the
sorted-window pass (kernel #4's table, its plain version here) and the
window pass's per-frame fallback to the full pass on a frame engineered
to miss the window (all atoms in a thin x-slab of a large box, as
``tests/test_cn_bad.py`` ``TestCnWindowMissFallback``).

Tolerance: exact. The counts are integers and the positions sit on a
1/32 A grid in power-of-two cubic cells (see test_torch_rdf).
"""

import numpy as np
import pytest
import torch

import amof_tpu.cn as jcn
import amof_tpu_torch.cn as tcn
from amof_tpu_torch.ops import pair_engine

from test_torch_api_rdf import assert_frames_equal, batches
from test_torch_pipeline import CUTOFFS, glass

torch.set_num_threads(2)


def slab_pair(n=2048, box=128.0, seed=11):
    """Frame 0: uniform in the box; frame 1: every atom in the slab
    0.48 < x/box < 0.52, where the sorted window misses."""
    rng = np.random.default_rng(seed)
    species = np.concatenate([np.full(n // 4, 30), np.full(3 * n // 4, 7)])
    pos = rng.uniform(0, box, (2, n, 3))
    pos[1, :, 0] = rng.uniform(0.48 * box, 0.52 * box, n)
    pos = (np.round(pos * 32) / 32).astype(np.float32)
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (2, 1, 1))
    return pos, cells, species.astype(np.int32)


@pytest.mark.parametrize("case,passes", [
    ("full", {"full": 3}),
    ("windowed", {"windowed": 3}),
    ("window_miss", {"windowed": 2, "full": 1}),
])
def test_cn_from_trajectory_matches_amof_tpu(case, passes, monkeypatch):
    if case == "full":
        arrays, cut = glass(n_frames=3, n_atoms=1024), CUTOFFS
    elif case == "windowed":
        arrays, cut = glass(n_frames=3, n_atoms=2048), CUTOFFS
    else:
        arrays, cut = slab_pair(), {"Zn-N": 2.8, "N-N": 2.2}
    batch, jb = batches(*arrays)
    seen = {"windowed": 0, "full": 0}
    for name, key in (("frame_cn_counts_windowed", "windowed"),
                      ("frame_cn_counts", "full")):
        fn = getattr(pair_engine, name)
        monkeypatch.setattr(
            pair_engine, name,
            lambda *a, _fn=fn, _k=key, **k: seen.__setitem__(_k, seen[_k] + 1)
            or _fn(*a, **k))
    got = tcn.CoordinationNumber.from_trajectory(batch, cut, delta_Step=5,
                                                 first_frame=10, device="cpu")
    ref = jcn.CoordinationNumber.from_trajectory(jb, cut, delta_Step=5,
                                                 first_frame=10)
    assert {k: v for k, v in seen.items() if v} == passes
    assert_frames_equal(got.data, ref.data)
    assert list(got.data["Step"]) == list(range(10, 10 + 5 * len(got.data),
                                                 5))
    assert (got.data.iloc[:, 1:].to_numpy() > 0).all()


def test_window_miss_is_flagged_and_counts_fall_back():
    """The frame on the thin slab misses; the uniform one does not, and
    its windowed counts equal the full pass's."""
    pos, cells, species = slab_pair()
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
