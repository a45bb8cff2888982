"""
Mean-squared displacement: the result class the fused step fills.

Counterpart of ``amof_tpu/msd.py`` (API parity with amof/msd.py):
``WindowMsd`` with ``.data`` ("Time", one column per species, the total
"X") and the '.msd' feather round-trip. The series come from
``pipelines.analyze``; ``WindowMsd.from_trajectory`` and ``DirectMsd``
are not ported yet. pandas is imported inside the class.
"""

from __future__ import annotations

import numpy as np

import amof_tpu_torch.files.path


class Msd:
    """Base class: '.msd' feather persistence (amof/msd.py:25-51)."""

    def write_to_file(self, path_to_output):
        path_to_output = amof_tpu_torch.files.path.append_suffix(
            path_to_output, "msd")
        self.data.to_feather(path_to_output)

    @classmethod
    def from_file(cls, path_to_msd):
        msd_class = cls()
        msd_class.read_msd_file(path_to_msd)
        return msd_class

    def read_msd_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "msd")
        self.data = pd.read_feather(path_to_data)


class WindowMsd(Msd):
    """Windowed MSD:
    MSD(m) = <|r_i(k+m) - r_i(k)|^2>_{i,k}, x-axis 'Time' in fs."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Time": np.empty([0])})
