"""Traffic kind ``entry``: aMOF's per-analysis entry points, one analysis
at a time, as the reference's example calls them
(``examples/compute_structural_properties.py``): ``rdf_columns``,
``cn_columns``, ``bad_columns`` and ``msd_columns`` of the port, one
after another on one trajectory piece a unit, host arrays in and numpy
columns out (each call ends in a host copy).

Mix parameters: ``pairs`` (the cutoff pairs of the configuration that CN
and BAD take, e.g. ``["Zn-N"]``), ``msd_delta_frames`` (frames between
two MSD lags; the lags stop below half the piece, aMOF's ``max_time=
'half'``). dr and dtheta are the configuration's; the RDF runs to half
the cell (aMOF's ``rmax='half_cell'``)."""

from __future__ import annotations

import numpy as np

from bench_torch.harness import span
from bench_torch.reference import entry as ref_entry

REHEARSAL_FRAMES = 8


def batch_of(piece):
    from amof_tpu_torch import FrameBatch

    return FrameBatch(piece["positions"], piece["cell"], piece["species"],
                      piece["step"])


def cutoffs_of(config, traffic):
    return {p: config["cutoffs_A"][p] for p in traffic["pairs"]}


def msd_lags(n_frames, traffic):
    """The window MSD's lags in frames: 0, d, 2d, ... below half the
    piece (aMOF's ``max_time='half'``)."""
    return np.arange(0, n_frames // 2, int(traffic["msd_delta_frames"]))


class Runner:
    def __init__(self, config, traffic, device):
        from amof_tpu_torch import bad, cn, msd, rdf

        self.mods = rdf, cn, bad, msd
        self.device = device
        self.dr = config["rdf_dr_A"]
        self.dtheta = config["bad_dtheta_deg"]
        self.cutoffs = cutoffs_of(config, traffic)
        self.traffic = traffic

    def unit(self, piece):
        rdf, cn, bad, msd = self.mods
        traj, step, dev = batch_of(piece), piece["step"], self.device
        lags = msd_lags(len(step), self.traffic)
        with span("entry.rdf"):
            out_rdf = rdf.rdf_columns(traj, dr=self.dr, rmax="half_cell",
                                      device=dev)
        with span("entry.cn"):
            out_cn = cn.cn_columns(traj, self.cutoffs, step, device=dev)
        with span("entry.bad"):
            out_bad = bad.bad_columns(traj, self.cutoffs,
                                      dtheta=self.dtheta, device=dev)
        with span("entry.msd"):
            out_msd = msd.msd_columns(traj, lags, step[lags], device=dev)
        return {"rdf": out_rdf, "cn": out_cn, "bad": out_bad,
                "msd": out_msd}


def reference(config, traffic, piece, device, dtype=None):
    import torch

    return ref_entry.columns(
        piece, config["elements"], cutoffs_of(config, traffic),
        config["rdf_dr_A"], config["bad_dtheta_deg"],
        msd_lags(len(piece["step"]), traffic), dtype or torch.float64,
        device)


def compare(out, ref, config=None, traffic=None):
    """The numbers ``correct`` compares (each at most its limit)."""
    return ref_entry.compare(out, ref)
