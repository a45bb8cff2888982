"""Host us a frame of the pore step's frame passes: the program's span
``pore.frame`` (kernels #5, #6, #7 and the torch work around them, first
passes and retries, not synced) over the first-pass frames (counter
``pore.frames`` less the traced units' frames), in the set-up unit and
the window, outside the profiler. None where the program has neither."""

from bench_torch import program


def read(tr):
    got = program.untraced_span(tr, "pore.frame")
    snap = program.totals()
    if got is None or snap is None:
        return None
    frames = snap["counts"].get("pore.frames", 0) - tr.frames
    if frames <= 0:
        return None
    return 1e6 * got[1] / frames
