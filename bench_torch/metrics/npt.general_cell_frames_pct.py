"""First-pass frames of the fused step that took the general-cell path
(cells not all diagonal) per 100 first-pass frames: the program's
counters ``pipeline.frames_general_cell`` over ``pipeline.frames``, over
the whole run. None where the program has no such counter."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None:
        return None
    counts = snap["counts"]
    if "pipeline.frames_general_cell" not in counts or \
            not counts.get("pipeline.frames"):
        return None
    return 100.0 * counts["pipeline.frames_general_cell"] / \
        counts["pipeline.frames"]
