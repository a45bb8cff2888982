from amof_tpu_torch.core.frames import Frame, FrameBatch, Trajectory, as_frame_batch
from amof_tpu_torch.core.step import construct_step

__all__ = ["Frame", "FrameBatch", "Trajectory", "as_frame_batch", "construct_step"]
