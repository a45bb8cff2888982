"""Frames the pore step's miss ladder computed again per 100 first-pass
frames: the program's counters ``pore.frames_retried`` (frames sent to a
widened-window retry, once a rung) and ``pore.frames_per_frame`` (frames
recomputed by ``zeopp.analyze_frame``) over ``pore.frames``, over the
whole run. None where the program has no such counter."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None or not snap["counts"].get("pore.frames"):
        return None
    counts = snap["counts"]
    return 100.0 * (counts.get("pore.frames_retried", 0)
                    + counts.get("pore.frames_per_frame", 0)) / \
        counts["pore.frames"]
