"""Host ms of one ``FusedAnalysis.prepare`` (layout, slab plan, upload of
a 256-frame piece), on the program's span ``pipeline.prepare``: its mean
over the set-up unit and the window, outside the profiler."""

from bench_torch import program


def read(tr):
    got = program.untraced_span(tr, "pipeline.prepare")
    if got is None:
        return None
    calls, seconds = got
    return 1e3 * seconds / calls
