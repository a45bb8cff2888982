"""Traffic kind ``pore``: aMOF's pore analysis, Zeo++'s ``network -sa
-vol`` on every frame as ``Pore.from_trajectory`` runs it
(coudertlab/amof ``amof/pore/core.py``), through the port's
``pore.core.pore_records`` (``BatchedPore.run``) on one trajectory piece
a unit, host arrays in, one record of Zeo++'s fields a frame out.
``Pore.from_trajectory`` wraps the same records in a pandas DataFrame,
which the card's machine lacks, so the unit stops at the records and
keeps their ASA, NASA, AV and NAV columns (A^2, A^3).

Mix parameters: ``options``, the keyword arguments of ``pore_records``
(probe_radius, chan_radius, num_samples, vol_method, conn_resolution,
resolution, frames_per_call, winding). The radii are the program's
defaults, Zeo++'s, which the configuration lists as ``vdw_radius_A``
for the reference. The configuration's ``zeopp`` group states the
deployment's probe, channel radius, samples and ``-vol`` estimator; a
mix whose options differ from it is refused before the program runs."""

from __future__ import annotations

import numpy as np

from bench_torch.reference import pore as ref_pore

REHEARSAL_FRAMES = 4

COLUMNS = {"asa": "ASA_A^2", "nasa": "NASA_A^2", "av": "AV_A^3",
           "nav": "NAV_A^3"}


class Runner:
    def __init__(self, config, traffic, device):
        zeopp = config.get("zeopp", {})
        for opt, key in (("probe_radius", "probe_radius_A"),
                         ("chan_radius", "chan_radius_A"),
                         ("num_samples", "num_samples"),
                         ("vol_method", "vol_method")):
            if key in zeopp and traffic["options"].get(opt) != zeopp[key]:
                raise SystemExit(f"pore: the mix's {opt} "
                                 f"{traffic['options'].get(opt)!r} is not "
                                 f"the configuration's {zeopp[key]!r}")
        from amof_tpu_torch.pore.core import pore_records

        self.records = pore_records
        self.device = device
        self.options = dict(traffic["options"])

    def unit(self, piece):
        from amof_tpu_torch import FrameBatch

        batch = FrameBatch(piece["positions"], piece["cell"],
                           piece["species"], piece["step"])
        recs = self.records(batch, piece["step"], device=self.device,
                            **self.options)
        if len(recs) != len(piece["step"]):
            # the program started its warmup, whose thread may be building
            # the kernels in nvcc processes that would outlive this one:
            # let them finish before the run stops
            from amof_tpu_torch.warmup import warmup

            warmup(block=True, device=self.device)
            raise SystemExit(f"pore: {len(recs)} records for "
                             f"{len(piece['step'])} frames")
        return {c: np.array([r[k] for r in recs], np.float64)
                for c, k in COLUMNS.items()}


def reference(config, traffic, piece, device, dtype=None):
    import torch

    return ref_pore.frames(piece, config["elements"], traffic["options"],
                           dtype or torch.float64, device)


def compare(out, ref, config=None, traffic=None):
    """The numbers ``correct`` compares (each at most its limit)."""
    return ref_pore.compare(out, ref)
