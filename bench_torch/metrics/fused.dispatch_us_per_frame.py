"""Host us a frame of the fused step's frame passes: the program's span
``pipeline.frame`` (RDF, neighbour table, angle histograms; first passes
and reruns, not synced) over the first-pass frames (``pipeline.frames``),
in the set-up unit and the window, outside the profiler."""

from bench_torch import program


def read(tr):
    got = program.untraced_span(tr, "pipeline.frame")
    frames = program.untraced_frames(tr)
    if got is None or frames is None:
        return None
    return 1e6 * got[1] / frames
