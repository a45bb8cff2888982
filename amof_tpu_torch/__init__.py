"""
amof_tpu_torch: the amof_tpu analyses in PyTorch, with hand-written CUDA
kernels for Hopper (H100) where the JAX package had Pallas TPU kernels.

This first slice ports the fused RDF + CN + BAD + MSD step
(``parallel.pipeline.FusedAnalysis``, ``pipelines.analyze``). Entry
points take ``device=`` ("cuda" by default; "cpu" runs the kernels'
plain PyTorch versions). The package never imports jax or amof_tpu.
"""

from amof_tpu_torch.core.frames import Frame, FrameBatch, as_frame_batch

__all__ = ["Frame", "FrameBatch", "as_frame_batch"]
