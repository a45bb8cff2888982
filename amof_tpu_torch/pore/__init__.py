"""Pore analysis: ``Pore`` over a trajectory and the batched ``-sa -vol``
step (``BatchedPore``, column path)."""

from amof_tpu_torch.pore.batch import BatchedPore
from amof_tpu_torch.pore.core import Pore

__all__ = ["BatchedPore", "Pore"]
