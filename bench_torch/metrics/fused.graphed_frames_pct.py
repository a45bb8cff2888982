"""First-pass frames of the fused step replayed from a CUDA graph per
100 first-pass frames: the program's counters ``pipeline.frames_graphed``
over ``pipeline.frames``, over the whole run. None where the program
has no such counter (no frame graphs)."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None:
        return None
    counts = snap["counts"]
    if "pipeline.frames_graphed" not in counts or \
            not counts.get("pipeline.frames"):
        return None
    return 100.0 * counts["pipeline.frames_graphed"] / \
        counts["pipeline.frames"]
