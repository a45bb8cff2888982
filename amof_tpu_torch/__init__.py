"""
amof_tpu_torch: the amof_tpu analyses in PyTorch, with hand-written CUDA
kernels for Hopper (H100) where the JAX package had Pallas TPU kernels.

Each analysis class (``rdf.Rdf``, ``rdf.CoordinationNumber``,
``cn.CoordinationNumber``, ``bad.Bad``, ``bad.BadByCn``,
``msd.WindowMsd``, ``msd.DirectMsd``, ``pore.Pore``, ``ring.Ring``) is
built from a trajectory (``trajectory.read_traj`` reads xyz, LAMMPS,
CP2K, VASP and CIF files) with
``from_trajectory`` / ``from_file``, keeps its result in ``.data`` and
writes it with ``write_to_file``; the fused step (``pipelines.analyze``,
``parallel.pipeline.FusedAnalysis``) and the batched pore step
(``pore.BatchedPore``) are the scale paths. Entry points take
``device=`` ("cuda" by default; "cpu" runs the kernels' plain PyTorch
versions). ``warmup()`` builds the kernels and pays the card's one-time
costs in the background. The package never imports jax or amof_tpu.
"""

from amof_tpu_torch.core.frames import (
    Frame,
    FrameBatch,
    Trajectory,
    as_frame_batch,
)
from amof_tpu_torch.warmup import warmup

__all__ = ["Frame", "FrameBatch", "Trajectory", "as_frame_batch", "warmup"]
