"""The port's ``cn.cn_columns`` on its sorted-window pass (kernel #4's
table), held to the same call forced onto the full O(N^2) pass
(``cn.sorted_window`` returning None), bit for bit, with the counters
``cn.frames``, ``cn.frames_windowed`` and ``cn.frames_full``.

On the CPU (kernel #4's plain version): a trajectory whose first and
last frames miss the window (every atom in a thin x-slab of a large box)
reruns those frames alone with the full pass.

On the card (``-m cuda``; skips without one): an 8-frame piece of the
benchmark's bonded glass network (9792 atoms) keeps every frame's
windowed counts; the slab trajectory falls back on its missing frame;
and the call's waits for the card do not grow with its frames (the miss
flags are read once a call, not once a frame).

The module imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cn_windowed.py -q

Tolerance: exact. The counts are integers; the slab frames sit on a
1/32 A grid in a power-of-two cubic cell.
"""

import warnings

import numpy as np
import pytest
import torch

from amof_tpu_torch import cn, tracing

torch.set_num_threads(2)

SLAB_CUTOFFS = {"Zn-N": 2.8, "N-N": 2.2}


def slab_frames(n_frames=2, slab=(1,), n=2048, box=128.0, seed=11):
    """Frames uniform in the box, but for each of ``slab`` every atom in
    the slab 0.48 < x/box < 0.52, where the sorted window misses. Returns
    (positions f32 [F, n, 3], cells f32 [F, 3, 3], species i32 [n])."""
    rng = np.random.default_rng(seed)
    species = np.concatenate([np.full(n // 4, 30), np.full(3 * n // 4, 7)])
    pos = rng.uniform(0, box, (n_frames, n, 3))
    for f in slab:
        pos[f, :, 0] = rng.uniform(0.48 * box, 0.52 * box, n)
    pos = (np.round(pos * 32) / 32).astype(np.float32)
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    return pos, cells, species.astype(np.int32)


def frame_batch(pos, cells, species):
    from amof_tpu_torch import FrameBatch

    return FrameBatch(pos, cells, species,
                      np.arange(len(pos), dtype=np.int32))


def counted_columns(batch, cutoffs, device):
    """``cn_columns`` on ``batch`` and the counters the call added."""
    before = tracing.snapshot()
    cols = cn.cn_columns(batch, cutoffs, np.arange(batch.num_frames),
                         device=device)
    counts = tracing.diff(tracing.snapshot(), before)["counts"]
    return cols, {k: counts.get(k, 0)
                  for k in ("cn.frames", "cn.frames_windowed",
                            "cn.frames_full")}


def assert_windowed_equals_full(batch, cutoffs, device, monkeypatch,
                                n_full):
    """The windowed call keeps all but ``n_full`` frames, and its columns
    equal the full pass's bit for bit."""
    got, counters = counted_columns(batch, cutoffs, device)
    f = batch.num_frames
    assert counters == {"cn.frames": f, "cn.frames_windowed": f - n_full,
                        "cn.frames_full": n_full}
    with monkeypatch.context() as m:
        m.setattr(cn, "sorted_window", lambda *a: None)
        ref, ref_counters = counted_columns(batch, cutoffs, device)
    assert ref_counters == {"cn.frames": f, "cn.frames_windowed": 0,
                            "cn.frames_full": f}
    assert list(got) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    return got


def test_flagged_frames_alone_rerun_on_the_cpu(monkeypatch):
    """Frames 0 and 3 of four miss; the rerun lands on their rows."""
    batch = frame_batch(*slab_frames(4, (0, 3)))
    got = assert_windowed_equals_full(batch, SLAB_CUTOFFS, "cpu",
                                      monkeypatch, n_full=2)
    # the slab frames are far denser than the uniform ones
    assert got["Zn-N"][[0, 3]].min() > 10 * got["Zn-N"][[1, 2]].max()


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel #4 vs the full pass)")
    return torch.device("cuda")


GLASS_FRAMES = 8


@pytest.fixture(scope="module")
def glass_piece():
    """An 8-frame piece of the benchmark's glass network (9792 atoms,
    drawn on the CPU from one seed) and the configuration's cutoffs."""
    from bench_torch import harness

    config = harness.Bench().config("zif4-glass-9792")
    piece, = harness.make_pieces(
        config, {"frames_per_piece": GLASS_FRAMES, "pieces": 1},
        2_718_281_828, "cpu")
    return (frame_batch(piece["positions"], piece["cell"],
                        piece["species"]), config["cutoffs_A"])


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [("Zn-N",), None])
def test_card_glass_keeps_every_windowed_frame(cuda, glass_piece, pairs,
                                               monkeypatch):
    batch, cutoffs = glass_piece
    if pairs is not None:
        cutoffs = {p: cutoffs[p] for p in pairs}
    assert_windowed_equals_full(batch, cutoffs, cuda, monkeypatch, n_full=0)


@pytest.mark.cuda
def test_card_window_miss_falls_back(cuda, monkeypatch):
    batch = frame_batch(*slab_frames(3, (1,)))
    assert_windowed_equals_full(batch, SLAB_CUTOFFS, cuda, monkeypatch,
                                n_full=1)


@pytest.mark.cuda
def test_card_waits_do_not_grow_with_frames(cuda, glass_piece):
    """Waits for the card (``set_sync_debug_mode("warn")``) of an 8-frame
    call are no more than a 4-frame call's: none a frame. (The first call
    under the warning mode once read one wait more than the next, so a
    call is made before the two that are compared.)"""
    batch, cutoffs = glass_piece
    cutoffs = {"Zn-N": cutoffs["Zn-N"]}
    half = batch._replace(positions=batch.positions[:4],
                          cell=batch.cell[:4], step=batch.step[:4])

    def waits(b):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                cn.cn_columns(b, cutoffs, np.arange(b.num_frames),
                              device=cuda)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in seen)

    waits(half)
    n4, n8 = waits(half), waits(batch)
    assert 1 <= n8 <= n4, (n4, n8)  # the flags' read, the columns' copy
