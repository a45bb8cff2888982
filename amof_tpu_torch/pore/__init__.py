"""Pore analysis: the batched ``-sa -vol`` step (column path)."""

from amof_tpu_torch.pore.batch import BatchedPore

__all__ = ["BatchedPore"]
