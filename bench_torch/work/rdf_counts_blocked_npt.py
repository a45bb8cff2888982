"""Kernel #1, ``rdf_counts_blocked``, on a flexible-cell piece: the work
of ``rdf_counts_blocked.py`` on the general-cell branch (44 operations a
pair), with the frames' cells from ``kinds/npt.py``'s ``deformed`` (the
harness hands ``work`` the piece as drawn, in its diagonal cell).

Pairs: the volume-weighted counts summed over the frames, over the
largest frame volume, halved. Each frame's counts are weighted by its own
volume, so this is a lower bound on the unordered pairs under the cut,
low by at most the piece's volume spread, (V_max - V_min) / V_max: the
share never reads high."""

import numpy as np

from bench_torch.harness import HERE, load_file_module
from bench_torch.kinds import npt

_K1 = load_file_module(HERE / "work" / "rdf_counts_blocked.py",
                       "bench_work_rdf_counts_blocked")

KERNELS = _K1.KERNELS


def work(out, piece, config, traffic=None, device="cpu"):
    """(bytes, f32 operations) of the kernel over one unit."""
    cells = npt.deformed(piece, config["npt"], device)["cell"]
    vols = np.abs(np.linalg.det(np.asarray(cells, np.float64)))
    counts = np.asarray(out["rdf_counts"], np.float64)
    pairs = float(counts.sum() / vols.max() / 2)
    f, n = piece["positions"].shape[:2]
    s, _, bins = counts.shape
    return f * (16 * n + 72 + 4 * s * s * bins), pairs * _K1.OPS_GENERAL
