"""The program's own spans and counters (``amof_tpu_torch.tracing``), as
the per-layer readers take them.

The registry sums over the process, and a run is one process
(``run.py``): the set-up unit, the window, then the traced units. Host
times are read outside the profiler, whose host cost stretches a traced
unit 2-3x: the traced units enter every span as a
``torch.profiler.record_function`` range, so the trace holds their calls
and times, and ``untraced_span`` takes those off the totals. What is
left is the set-up unit and the window. A program without the registry
(a commit before it) reads None, and so does every reader built on it.
"""

from __future__ import annotations


def totals():
    """The registry's snapshot now, or None where the program has none."""
    try:
        from amof_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def untraced_span(tr, name):
    """(calls, seconds) of span ``name`` outside the traced units (the
    set-up unit and the window), or None where it has no such call."""
    snap = totals()
    if snap is None or name not in snap["spans"]:
        return None
    calls, seconds, _ = snap["spans"][name]
    traced = tr.spans(name)
    calls -= len(traced)
    seconds -= sum(e - s for s, e in traced) / 1e6
    return (calls, seconds) if calls > 0 else None


def untraced_frames(tr):
    """First-pass frames of the fused step outside the traced units (the
    counter ``pipeline.frames`` less the traced units' frames), or None."""
    snap = totals()
    if snap is None:
        return None
    frames = snap["counts"].get("pipeline.frames", 0) - tr.frames
    return frames if frames > 0 else None
