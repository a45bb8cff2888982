"""Host ms a frame of the port's ``bad_columns`` in the traced units: the
benchmark's span ``entry.bad`` (profiler clock, us) over the units'
frames. The call ends in a host copy of its columns, so the span holds
its device work; the profiler stretches the host side (its cost on every
host operation), so the number reads above the call's share of the
untraced window."""


def read(tr):
    spans = tr.spans("entry.bad")
    if not spans or not tr.frames:
        return None
    return sum(e - s for s, e in spans) / 1e3 / tr.frames
