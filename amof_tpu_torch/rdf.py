"""
Radial distribution functions: the result class and the helpers the
fused step needs.

Counterpart of ``amof_tpu/rdf.py`` (API parity with amof/rdf.py): ``Rdf``
with ``.data`` ("r", "X-X", every ordered "A-B" partial, "A-X" row sums),
``write_to_file``/``from_file`` with the '.rdf' feather suffix, the
``bins = int(rmax // dr)`` binning and exact shell volumes. The counts
come from ``pipelines.analyze`` (the fused step); ``Rdf.from_trajectory``
is not ported yet.

pandas is imported inside the class, so the package imports without it.
"""

from __future__ import annotations

import numpy as np

import amof_tpu_torch.files.path


def _species_table(species: np.ndarray):
    """Sorted unique atomic numbers + dense index mapping."""
    unique = np.array(sorted(set(np.asarray(species).tolist())))
    z_to_idx = np.full(int(unique.max()) + 1, -1, dtype=np.int32)
    z_to_idx[unique] = np.arange(len(unique), dtype=np.int32)
    return unique, z_to_idx


def shell_volumes(bins: int, dr: float) -> np.ndarray:
    """Exact spherical shell volumes 4pi/3((r+dr)^3 - r^3)."""
    edges = np.arange(bins + 1) * dr
    return 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)


class Rdf:
    """Total + all-pairs partial g(r) over a trajectory."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"r": np.empty([0])})

    @classmethod
    def from_file(cls, path_to_rdf):
        rdf_class = cls()
        rdf_class.read_rdf_file(path_to_rdf)
        return rdf_class

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "rdf")
        self.data.to_feather(filename)

    def read_rdf_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "rdf")
        self.data = pd.read_feather(path_to_data)
