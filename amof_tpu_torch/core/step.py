"""
Simulation-step index construction.

Behavior parity with amof/trajectory.py:244-283 (``construct_step``): the
same constructor combinations and precedence are honored.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def construct_step(**kwargs):
    """Construct the array of simulation steps labeling each frame.

    Accepted keyword combinations (same precedence as the reference):
      - step: slice or array -> used directly
      - delta_Step + (first_frame & last_frame) -> arange
      - delta_Step + number_of_frames (+ first_frame or last_frame)
      - number_of_frames + first_frame + last_frame -> linspace
    """
    delta_Step = kwargs.get("delta_Step", None)
    first_frame = kwargs.get("first_frame", None)
    last_frame = kwargs.get("last_frame", None)
    number_of_frames = kwargs.get("number_of_frames", None)
    step = kwargs.get("step", None)

    try:
        if step is not None:
            if isinstance(step, slice):
                return np.array(list(range(step.start or 0, step.stop, step.step or 1)))
            return np.array(step)
        if delta_Step is not None:
            if first_frame is not None and last_frame is not None:
                return np.arange(first_frame, last_frame, delta_Step)
            if number_of_frames is not None:
                if first_frame is None and last_frame is not None:
                    first_frame = last_frame - number_of_frames * delta_Step
                if first_frame is not None:
                    return np.arange(
                        first_frame,
                        first_frame + number_of_frames * delta_Step,
                        delta_Step,
                    )
        elif number_of_frames is not None:
            if first_frame is not None and last_frame is not None:
                return np.linspace(first_frame, last_frame, number_of_frames)
    except Exception:
        logger.exception("Cannot construct step from provided args")
        raise ValueError
    raise ValueError("Cannot construct step from provided args")
