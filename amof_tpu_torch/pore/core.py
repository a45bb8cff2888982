"""
Pore analysis over a trajectory.

Counterpart of ``amof_tpu/pore/core.py`` (API parity with
amof/pore/core.py): ``Pore.from_trajectory(traj, delta_Step, first_frame,
parallel, device='cuda', **kwargs)`` with one row per frame holding the
Zeo++ ``-sa``/``-vol`` output fields, ``read_zeopp`` for stored Zeo++
output files, and the '.pore' feather round-trip.

Where every keyword argument is a batchable one of ``amof_tpu``
(probe_radius, chan_radius, num_samples, radii, resolution, grid,
window, winding) or ``BatchedPore``'s volume estimator (vol_method,
conn_resolution: the bench's MC configuration) and group size
(frames_per_call), all frames run through ``BatchedPore``. Any other
option set (psd, chan, res, block, ray_atom, mass, ...) takes the
per-frame path, as in ``amof_tpu``:
``zeopp.analyze_frame(frame, sa=True, vol=True, **kwargs)`` for each
frame, fanned out over ``parallel`` host threads, keeping the scalar
fields. A frame that the analysis rejects (a ValueError, TypeError,
IndexError, KeyError or ArithmeticError) is dropped with a warning, as
the reference drops a Zeo++ timeout; a RuntimeError (a build, kernel
launch, CUDA, cuFFT or cuBLAS error, out of memory) is never dropped and
propagates. Unlike ``amof_tpu``, a failure of the batch
path propagates too instead of sending every frame down the per-frame
path: it would hide a kernel fault.

The device work lives in ``pore_records`` (a list of dicts, no pandas);
the class wraps them in a DataFrame.
"""

from __future__ import annotations

import logging

import numpy as np

import amof_tpu_torch.files.path
from amof_tpu_torch.core.frames import FrameBatch, as_frame_batch, as_frames
from amof_tpu_torch.core.step import construct_step
from amof_tpu_torch.parallel.host import parallel_map
from amof_tpu_torch.pore import zeopp
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)

_BATCHABLE_KWARGS = frozenset(
    ("probe_radius", "chan_radius", "num_samples", "radii", "resolution",
     "grid", "window", "winding", "vol_method", "conn_resolution",
     "frames_per_call")
)
# what a frame's analysis raises on a frame it cannot analyse; every
# RuntimeError (a build or kernel launch, CUDA, cuFFT, cuBLAS, out of
# memory: torch's errors and KernelError) and every other error propagates
_FRAME_ERRORS = (ValueError, TypeError, IndexError, KeyError,
                 ArithmeticError)


def pore_records(trajectory, step, device="cuda", parallel=False,
                 **kwargs):
    """One dict per frame: {"Step": s, Zeo++ -sa/-vol fields} (frames the
    per-frame path drops are left out)."""
    dev = resolve_device(device)
    if set(kwargs) <= _BATCHABLE_KWARGS:
        from amof_tpu_torch.pore.batch import BatchedPore

        batch = as_frame_batch(trajectory)
        logger.info("Start pore analysis for volume and surfaces for %s "
                    "frames", batch.num_frames)
        records, _ = BatchedPore(**kwargs).run(batch, device=dev)
        return [{"Step": s, **rec} for s, rec in zip(step, records)]
    frames = as_frames(trajectory)
    logger.info("Start pore analysis for volume and surfaces for %s frames",
                len(frames))
    # the per-frame path always runs the exact winding analysis; `winding`
    # only selects the batched policy
    kwargs.pop("winding", None)
    results = parallel_map(
        lambda args: get_surface_volume(args[1], step[args[0]], dev,
                                        **kwargs),
        list(enumerate(frames)), parallel)
    return [d for d in results if d is not None]


def get_surface_volume(frame, step, device="cuda", **kwargs):
    """{"Step": step, scalar fields of ``zeopp.analyze_frame(frame,
    sa=True, vol=True, **kwargs)``}, or None (with a warning) where the
    analysis rejects the frame (a ValueError, TypeError, IndexError,
    KeyError or ArithmeticError). A RuntimeError (build, launch, CUDA,
    cuFFT, cuBLAS, out of memory) and any other error propagates."""
    try:
        result = zeopp.analyze_frame(frame, sa=True, vol=True,
                                     device=device, **kwargs)
    except _FRAME_ERRORS:
        logger.warning(
            "Pore analysis failed. System size: %s; Step: %s",
            frame.get_global_number_of_atoms(), step, exc_info=True,
        )
        return None
    dic = {"Step": step}
    dic.update({k: v for k, v in result.items() if np.isscalar(v)})
    return dic


class Pore:
    """Probe-accessible surface and volume per frame."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(cls, trajectory, delta_Step=1, first_frame=0,
                        parallel=False, device="cuda", **kwargs):
        """kwargs go to ``BatchedPore`` where all are batchable, else to
        ``zeopp.analyze_frame`` frame by frame (probe_radius, chan_radius,
        num_samples, radii, resolution, psd, chan, ...)."""
        pore_class = cls()
        n_frames = (trajectory.num_frames
                    if isinstance(trajectory, FrameBatch)
                    else len(as_frames(trajectory)))
        step = construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=n_frames,
        )
        pore_class.compute_surface_volume(trajectory, step, parallel,
                                          device, **kwargs)
        return pore_class

    def compute_surface_volume(self, frames, step, parallel=False,
                               device="cuda", **kwargs):
        """``parallel`` (the reference's joblib toggle) fans the per-frame
        path out over host threads; batched frames run as one batch."""
        import pandas as pd

        records = pore_records(frames, step, device, parallel, **kwargs)
        if records:
            self.data = pd.DataFrame(records)

    get_surface_volume = staticmethod(get_surface_volume)

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
