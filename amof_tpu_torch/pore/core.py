"""
Pore analysis over a trajectory.

Counterpart of ``amof_tpu/pore/core.py`` (API parity with
amof/pore/core.py): ``Pore.from_trajectory(traj, delta_Step, first_frame,
parallel, device='cuda', **kwargs)`` with one row per frame holding the
Zeo++ ``-sa``/``-vol`` output fields, ``read_zeopp`` for stored Zeo++
output files, and the '.pore' feather round-trip.

Every frame runs through ``BatchedPore`` (column path, kernels #5-#7).
Its keyword arguments are the batchable ones of ``amof_tpu``
(probe_radius, chan_radius, num_samples, radii, resolution, grid,
window, winding) plus ``BatchedPore``'s volume estimator (vol_method,
conn_resolution: the bench's MC configuration). ``amof_tpu`` hands any
other option set, and frames the batch path fails on, to its per-frame
Zeo++-style path (``zeopp.analyze_frame``), which is not ported yet: the
port raises ``NotImplementedError`` on such options and lets batch-path
errors propagate; it never falls back quietly.

The device work lives in ``pore_records`` (a list of dicts, no pandas);
the class wraps them in a DataFrame.
"""

from __future__ import annotations

import logging

import numpy as np

import amof_tpu_torch.files.path
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.core.step import construct_step

logger = logging.getLogger(__name__)

_BATCHABLE_KWARGS = frozenset(
    ("probe_radius", "chan_radius", "num_samples", "radii", "resolution",
     "grid", "window", "winding", "vol_method", "conn_resolution")
)


def pore_records(trajectory, step, device="cuda", **kwargs):
    """One dict per frame: {"Step": s, Zeo++ -sa/-vol fields}."""
    from amof_tpu_torch.pore.batch import BatchedPore

    other = sorted(set(kwargs) - _BATCHABLE_KWARGS)
    if other:
        raise NotImplementedError(
            f"pore options {other} take the per-frame Zeo++-style path "
            "(zeopp.analyze_frame), which is not ported yet"
        )
    batch = as_frame_batch(trajectory)
    logger.info("Start pore analysis for volume and surfaces for %s frames",
                batch.num_frames)
    records, _ = BatchedPore(**kwargs).run(batch, device=device)
    return [{"Step": s, **rec} for s, rec in zip(step, records)]


class Pore:
    """Probe-accessible surface and volume per frame."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(cls, trajectory, delta_Step=1, first_frame=0,
                        parallel=False, device="cuda", **kwargs):
        """kwargs go to ``BatchedPore`` (probe_radius, chan_radius,
        num_samples, radii, resolution, vol_method, ...)."""
        pore_class = cls()
        batch = as_frame_batch(trajectory)
        step = construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        pore_class.compute_surface_volume(batch, step, parallel, device,
                                          **kwargs)
        return pore_class

    def compute_surface_volume(self, frames, step, parallel=False,
                               device="cuda", **kwargs):
        import pandas as pd

        del parallel  # the reference's joblib toggle: frames run batched
        self.data = pd.DataFrame(pore_records(frames, step, device, **kwargs))

    @staticmethod
    def read_zeopp(filename):
        """Parse a Zeo++ ``.sa``/``.vol`` output file's first line into a
        {field: value} dict (parity: amof/pore/core.py:70-82)."""
        import re

        with open(filename) as f:
            first_line = f.readline().strip("\n")
        tokens = re.split(r" +", first_line.strip())
        tokens = tokens[6:]  # drop file name, density, unit-cell volume
        keys = [t.strip(":") for t in tokens[::2]]
        values = [float(t) for t in tokens[1::2]]
        return dict(zip(keys, values))

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "pore")
        self.data.to_feather(filename)

    @classmethod
    def from_file(cls, filename):
        pore_class = cls()
        pore_class.read_surface_volume_file(filename)
        return pore_class

    def read_surface_volume_file(self, filename):
        import pandas as pd

        filename = amof_tpu_torch.files.path.append_suffix(filename, "pore")
        self.data = pd.read_feather(filename)
