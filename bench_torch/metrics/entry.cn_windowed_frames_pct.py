"""Frames of the port's ``cn_columns`` whose counts came from the
sorted-window table (kernel #4) per 100 frames into it: the program's
counters ``cn.frames_windowed`` over ``cn.frames``, over the whole run.
None where the program has no such counter."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None:
        return None
    counts = snap["counts"]
    if "cn.frames_windowed" not in counts or not counts.get("cn.frames"):
        return None
    return 100.0 * counts["cn.frames_windowed"] / counts["cn.frames"]
