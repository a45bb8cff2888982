"""Frame passes of the fused step's rerun ladder per 100 first-pass
frames: the program's counters ``pipeline.frames_rerun`` over
``pipeline.frames``, over the whole run."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None or not snap["counts"].get("pipeline.frames"):
        return None
    counts = snap["counts"]
    return 100.0 * counts.get("pipeline.frames_rerun", 0) / \
        counts["pipeline.frames"]
