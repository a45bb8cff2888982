"""The port's span and counter registry (``amof_tpu_torch.tracing``) and
the spans and counters of the fused step, on the CPU.

The registry: nesting and self time, counters and ``diff``, writers on
many threads at once. The fused step (``FusedAnalysis``' plain path on a
small glass): one ``pipeline.frame`` a frame and one ``pipeline.prepare``
a ``prepare``; under ``torch.profiler`` the spans are ranges of the trace,
nested as they run; without a profiler no range is entered; a crowded
frame raises the rerun counters and ``meta["reruns"]``, and the outputs
with a profiler running equal those without.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from amof_tpu_torch import FrameBatch, tracing
from amof_tpu_torch.parallel.pipeline import RERUNS, FusedAnalysis

torch.set_num_threads(2)

CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}
KW = dict(dr=0.05, dtheta=1.0, chunk=128)


def glass(n_frames=2, n_atoms=1024, seed=0, crowd_frame=None):
    """Zn(C3N2H3)2 stoichiometry at the bench glass's density (1024 atoms
    in a 25.4 A box), a thermal random walk; in ``crowd_frame`` twelve N
    atoms within 1.7 A of the first Zn, which then has more than 8
    neighbours."""
    rng = np.random.default_rng(seed)
    box = 25.4
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate(
        [np.full(c, z, np.int32) for z, c in counts.items()])
    base = rng.uniform(0, box, (n_atoms, 3))
    pos = (base[None] + np.cumsum(
        rng.normal(0, 0.1, (n_frames, n_atoms, 3)), axis=0)) % box
    if crowd_frame is not None:
        off = rng.normal(0, 1, (12, 3))
        off *= (rng.uniform(1.0, 1.7, 12)
                / np.linalg.norm(off, axis=1))[:, None]
        n_zn = counts[30]
        pos[crowd_frame, n_zn:n_zn + 12] = (pos[crowd_frame, 0] + off) % box
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    return FrameBatch(pos.astype(np.float32), cells, species,
                      np.arange(n_frames, dtype=np.int32))


def recorded(fn):
    """(fn's result, what the registry recorded during it)."""
    before = tracing.snapshot()
    out = fn()
    return out, tracing.diff(tracing.snapshot(), before)


# --------------------------------------------------------------------------
# The registry
# --------------------------------------------------------------------------

def test_nested_spans_give_inclusive_and_self_time():
    def work():
        with tracing.span("test.outer"):
            time.sleep(0.02)
            for _ in range(2):
                with tracing.span("test.inner"):
                    time.sleep(0.01)

    _, got = recorded(work)
    outer, inner = got["spans"]["test.outer"], got["spans"]["test.inner"]
    assert outer[0] == 1 and inner[0] == 2
    assert inner[1] >= 0.02 and inner[2] == inner[1]  # a leaf: all self
    assert outer[1] >= 0.04
    assert outer[2] == pytest.approx(outer[1] - inner[1], abs=1e-12)
    assert 0.02 <= outer[2] < outer[1]


def test_a_span_records_when_its_block_raises():
    def work():
        with pytest.raises(KeyError):
            with tracing.span("test.raises"):
                raise KeyError("x")
        with tracing.span("test.after"):  # the stack was popped
            pass

    _, got = recorded(work)
    assert got["spans"]["test.raises"][0] == 1
    after = got["spans"]["test.after"]
    assert after[1] == after[2]


def test_counts_add_seconds_and_diff():
    def work():
        tracing.count("test.a")
        tracing.count("test.a", 4)
        tracing.count("test.b", 2)
        tracing.add_seconds("test.device", 0.25)
        tracing.add_seconds("test.device", 0.5)

    mid = tracing.snapshot()
    _, got = recorded(work)
    assert got["counts"] == {"test.a": 5, "test.b": 2}
    assert got["spans"] == {"test.device": [2, 0.75, 0.75]}
    # names with nothing new are left out of a diff
    tracing.count("test.b")
    after = tracing.diff(tracing.snapshot(), mid)
    assert after["counts"] == {"test.a": 5, "test.b": 3}
    again = tracing.snapshot()
    assert tracing.diff(again, again) == {"spans": {}, "counts": {}}
    # a snapshot is a copy: later writes do not change it
    tracing.count("test.a")
    assert again["counts"]["test.a"] + 1 == \
        tracing.snapshot()["counts"]["test.a"]


def test_threads_writing_at_once_lose_nothing():
    n_threads, n_iter = 16, 400
    barrier = threading.Barrier(n_threads)

    def writer():
        barrier.wait(timeout=30)
        for _ in range(n_iter):
            with tracing.span("test.thread.outer"):
                tracing.count("test.thread")
                with tracing.span("test.thread.inner"):
                    tracing.count("test.thread", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            threads = [threading.Thread(target=writer)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            return threads

        threads, got = recorded(work)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * n_iter
    assert got["counts"]["test.thread"] == 3 * n
    outer = got["spans"]["test.thread.outer"]
    inner = got["spans"]["test.thread.inner"]
    assert outer[0] == inner[0] == n
    # each thread nests on its own stack: the outer spans' self time is
    # their time less their own inner spans', never another thread's
    assert outer[2] == pytest.approx(outer[1] - inner[1], rel=1e-9)
    assert outer[2] >= 0


# --------------------------------------------------------------------------
# The fused step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    return glass()


def test_fused_run_counts_a_frame_span_per_frame(batch):
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    (out, meta), got = recorded(lambda: fa.run(batch, device="cpu"))
    spans, counts = got["spans"], got["counts"]
    n = batch.num_frames
    assert meta["bad_slab"] is not None  # the slab layout ran
    assert not out["bad_overflow"].any()
    assert spans["pipeline.prepare"][0] == 1
    assert spans["pipeline.step"][0] == 1
    assert spans["pipeline.frame"][0] == n
    assert spans["pipeline.frame.rdf"][0] == n
    assert spans["bad.table"][0] == spans["bad.angles"][0] == n
    assert counts["pipeline.frames"] == n
    assert meta["reruns"] == dict.fromkeys(RERUNS, 0)
    for name in ("pipeline.prepare.layout", "pipeline.prepare.slab_plan",
                 "pipeline.prepare.upload", "pipeline.sums",
                 "pipeline.flags_read", "pipeline.rerun", "pipeline.msd",
                 "pipeline.download"):
        assert spans[name][0] >= 1, name
    # the children sit inside their parents
    assert spans["pipeline.step"][1] >= spans["pipeline.frame"][1]
    assert spans["pipeline.frame"][1] >= (spans["bad.table"][1]
                                          + spans["bad.angles"][1])
    # a second prepare is one more call
    _, again = recorded(lambda: fa.prepare(batch, device="cpu"))
    assert again["spans"]["pipeline.prepare"][0] == 1
    assert "pipeline.step" not in again["spans"]


def test_spans_nest_in_a_profiler_trace(batch):
    from torch.profiler import ProfilerActivity, profile

    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fa.run(batch, device="cpu")
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))

    def inside(child, parents):
        return all(any(s0 <= s and e <= e0 for s0, e0 in ranges[parents])
                   for s, e in ranges[child])

    assert len(ranges["pipeline.step"]) == 1
    assert len(ranges["pipeline.frame"]) == batch.num_frames
    assert len(ranges["bad.angles"]) == batch.num_frames
    assert inside("pipeline.frame", "pipeline.step")
    assert inside("bad.angles", "pipeline.frame")
    assert inside("pipeline.frame.rdf", "pipeline.frame")
    assert inside("pipeline.prepare.upload", "pipeline.prepare")


def test_no_range_is_entered_without_a_profiler(batch, monkeypatch):
    entered = []

    def spy(name, *args, **kwargs):
        entered.append(name)
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=8, frames_per_call=2)
    _, got = recorded(lambda: fa.run(batch, device="cpu"))
    assert entered == []
    assert got["spans"]["pipeline.frame"][0] == batch.num_frames


@pytest.mark.parametrize("case", ["window", "full_table", "escalated"])
def test_reruns_are_counted_and_outputs_equal_untraced(case):
    """A crowded frame past ``max_neighbors`` reruns on the 1-level window
    (``bad_window`` auto) or on the full table (``bad_window`` None); at K
    2 most frames of a group flag and the group escalates. The counters,
    ``meta["reruns"]`` and the outputs with a profiler running equal
    those of an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    k, window = {"window": (8, "auto"), "full_table": (8, None),
                 "escalated": (2, "auto")}[case]
    crowded = glass(crowd_frame=1)
    fa = FusedAnalysis(CUTOFFS, **KW, max_neighbors=k, bad_window=window,
                       frames_per_call=2)
    (out, meta), got = recorded(lambda: fa.run(crowded, device="cpu"))
    reruns = meta["reruns"]
    assert reruns == {key: got["counts"].get("pipeline." + key, 0)
                      for key in RERUNS}
    assert not out["bad_overflow"].any()
    if case == "escalated":
        assert reruns["groups_escalated"] >= 1
    else:
        assert reruns["groups_escalated"] == 0
        assert reruns["frames_rerun"] >= 1
        assert reruns["frames_full_table"] == (case == "full_table")
    passes = crowded.num_frames * (1 + reruns["groups_escalated"]) \
        + reruns["frames_rerun"]
    assert got["spans"]["pipeline.frame"][0] == passes
    assert got["spans"]["pipeline.rerun"][0] == 1

    fresh = FusedAnalysis(CUTOFFS, **KW, max_neighbors=k, bad_window=window,
                          frames_per_call=2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, traced_meta = fresh.run(crowded, device="cpu")
    assert traced_meta["reruns"] == reruns
    assert out.keys() == traced.keys()
    for name in out:
        np.testing.assert_array_equal(out[name], traced[name], err_msg=name)
