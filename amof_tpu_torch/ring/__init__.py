from amof_tpu_torch.ring.core import Ring, frame_ring_census

__all__ = ["Ring", "frame_ring_census"]
