"""
Bond-angle distributions: the result class and the spec enumeration the
fused step needs.

Counterpart of ``amof_tpu/bad.py`` (API parity with amof/bad.py): ``Bad``
with ``.data`` (density-normalized B-A-B columns over ``theta``), the
wildcard "X" enumeration (amof/bad.py:122-133) and the '.bad' feather
round-trip. The counts come from ``pipelines.analyze``;
``Bad.from_trajectory`` and ``BadByCn`` are not ported yet. pandas is
imported inside the class.
"""

from __future__ import annotations

import numpy as np

import amof_tpu_torch.files.path
from amof_tpu_torch.data import elements


def _enumerate_specs(nb_set_and_cutoff, unique):
    """Wildcard-aware (center, outer) pair enumeration + column names.

    Mirrors amof/bad.py:122-133: "X" is appended iff the cutoff spec
    covers every species present; pairs with identical center and outer
    species are excluded except ("X", "X").
    """
    present = sorted(
        {
            elements.atomic_numbers[s]
            for nb_set in nb_set_and_cutoff
            for s in nb_set.split("-")
        }
    )
    epu: list = list(present)
    if len(epu) == len(unique):
        epu.append("X")
    pairs = [
        (a, b)
        for b in epu
        for a in epu
        if (a not in [b, "X"] or ((a, b) == ("X", "X")))
    ]
    names = []
    for a, b in pairs:
        sym = lambda x: "X" if x == "X" else elements.symbol_of(x)
        names.append("-".join([sym(b), sym(a), sym(b)]))
    return pairs, names


class Bad:
    """Bond-angle distribution, density-normalized over all frames."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"theta": np.empty([0])})

    @classmethod
    def from_file(cls, filename):
        bad_class = cls()
        bad_class.read_bad_file(filename)
        return bad_class

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data.to_feather(filename)

    def read_bad_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "bad")
        self.data = pd.read_feather(path_to_data)
