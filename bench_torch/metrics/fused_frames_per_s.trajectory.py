"""Frames a second of the fused step on the host's clock: all the frames
of the untraced window over its whole time (the window that runs before
the traced units)."""


def read(tr):
    if not tr.window_frames or tr.window_seconds <= 0:
        return None
    return tr.window_frames / tr.window_seconds
