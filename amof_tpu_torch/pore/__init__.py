"""Pore analysis: ``Pore`` over a trajectory, the batched ``-sa -vol``
step (``BatchedPore``) and the per-frame Zeo++-style analysis
(``zeopp.analyze_frame`` / ``zeopp.network``)."""

from amof_tpu_torch.pore.batch import BatchedPore
from amof_tpu_torch.pore.core import Pore

__all__ = ["BatchedPore", "Pore"]
