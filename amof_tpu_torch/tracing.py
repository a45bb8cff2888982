"""
Spans and counters of the port: one registry a process.

``with span("pipeline.frame"):`` adds the block's wall time to the
name's entry: calls, inclusive seconds, and self seconds (inclusive less
the time of the spans opened inside it on the same thread). Spans nest
per thread; the warmup thread keeps its own stack. When a profiler runs
(``torch.autograd._profiler_enabled()``), a span is also a
``torch.profiler.record_function`` range of the same name, so the
profiler's timeline carries it beside the host operations and the
device's kernels. With no profiler a span costs a flag test, two clock
reads and one locked update.

``count(name, n)`` adds to an integer counter. ``snapshot()`` returns
``{"spans": {name: [calls, seconds, self_seconds]}, "counts": {name: n}}``
as plain values, ``diff(after, before)`` what happened between two
snapshots, ``reset()`` empties the registry. The names the port records
are listed in README.md ("Spans and counters").
"""

from __future__ import annotations

import threading
import time

import torch

_lock = threading.Lock()
_spans = {}   # name -> [calls, seconds, self seconds]
_counts = {}  # name -> n
_local = threading.local()  # .stack: the open spans of this thread
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter


def _add(name: str, seconds: float, self_seconds: float) -> None:
    with _lock:
        entry = _spans.get(name)
        if entry is None:
            _spans[name] = [1, seconds, self_seconds]
        else:
            entry[0] += 1
            entry[1] += seconds
            entry[2] += self_seconds


class span:
    """Context manager that times its block under ``name``."""

    __slots__ = ("name", "_t0", "_inner", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._inner = 0.0
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        seconds = _clock() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._inner += seconds
        _add(self.name, seconds, seconds - self._inner)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def add_seconds(name: str, seconds: float) -> None:
    """One call of ``seconds`` under span ``name``, timed elsewhere (a
    device time from CUDA events, say)."""
    _add(name, seconds, seconds)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def snapshot() -> dict:
    with _lock:
        return {"spans": {k: list(v) for k, v in _spans.items()},
                "counts": dict(_counts)}


def diff(after: dict, before: dict) -> dict:
    """What was recorded between two snapshots (names with no new call
    or count left out)."""
    old = before["spans"]
    spans = {}
    for name, (calls, secs, own) in after["spans"].items():
        c0, s0, o0 = old.get(name, (0, 0.0, 0.0))
        if calls != c0:
            spans[name] = [calls - c0, secs - s0, own - o0]
    counts = {name: n - before["counts"].get(name, 0)
              for name, n in after["counts"].items()
              if n != before["counts"].get(name, 0)}
    return {"spans": spans, "counts": counts}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counts.clear()
