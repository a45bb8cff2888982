"""Host ms of one ``BatchedPore.prepare`` (plans, MC points and upload of
a 32-frame piece; a widened-window retry prepares again), on the
program's span ``pore.prepare``: its mean over the set-up unit and the
window, outside the profiler. None where the program has no such span."""

from bench_torch import program


def read(tr):
    got = program.untraced_span(tr, "pore.prepare")
    if got is None:
        return None
    calls, seconds = got
    return 1e3 * seconds / calls
