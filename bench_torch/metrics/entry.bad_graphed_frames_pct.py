"""First-pass frames of the port's ``bad_columns`` replayed from a CUDA
graph per 100 first-pass frames: the program's counters
``bad.frames_graphed`` over ``bad.frames``, over the whole run. None
where the program has no such counter."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None:
        return None
    counts = snap["counts"]
    if "bad.frames_graphed" not in counts or not counts.get("bad.frames"):
        return None
    return 100.0 * counts["bad.frames_graphed"] / counts["bad.frames"]
