"""
Cutoff coordination numbers: the result class and the cutoff matrix the
fused step needs.

Counterpart of ``amof_tpu/cn.py`` (API parity with amof/cn.py):
``CoordinationNumber`` with ``.data`` (per-frame mean CN per pair spec,
indexed by Step) and the '.cn' feather round-trip. The counts come from
``pipelines.analyze``; ``CoordinationNumber.from_trajectory`` is not
ported yet. pandas is imported inside the class.
"""

from __future__ import annotations

import numpy as np

import amof_tpu_torch.files.path
from amof_tpu_torch.data import elements


def format_cutoff(nb_set_and_cutoff):
    """{'Zn-N': 2.5, ...} -> {(30, 7): 2.5, ...} (amof/atom.py:48-70)."""
    return {
        tuple(elements.atomic_numbers[s] for s in nn_set.split("-")): cutoff
        for nn_set, cutoff in nb_set_and_cutoff.items()
    }


def _cutoff_matrix_for_species(nb_set_and_cutoff, unique, z_to_idx):
    """[S, S] symmetric cutoff matrix over dense species indices."""
    n_species = len(unique)
    mat = np.zeros((n_species, n_species), dtype=np.float32)
    for (a, b), cutoff in format_cutoff(nb_set_and_cutoff).items():
        ia, ib = int(z_to_idx[a]), int(z_to_idx[b])
        mat[ia, ib] = cutoff
        mat[ib, ia] = cutoff
    return mat


class CoordinationNumber:
    """Mean coordination number per frame and pair spec."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_file(cls, filename):
        cn_class = cls()
        cn_class.read_cn_file(filename)
        return cn_class

    def read_cn_file(self, filename):
        import pandas as pd

        filename = amof_tpu_torch.files.path.append_suffix(filename, "cn")
        self.data = pd.read_feather(filename)

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "cn")
        self.data.to_feather(filename)
