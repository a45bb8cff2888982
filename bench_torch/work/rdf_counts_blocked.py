"""Kernel #1, ``rdf_counts_blocked`` (the species-blocked RDF pair
histogram of the fused step): the work one frame's histogram needs,
whatever computes it.

Bytes: every atom read once (x, y, z float32 and a species index: 16 B),
the cell and its inverse (72 B), the float32 [S, S, bins] histogram
written once. Operations: only the unordered pairs under the cut, read
off the output (the sum of the volume-weighted ordered-pair counts over
V, halved); per pair the minimum-image distance in an orthorhombic cell
(3 differences, 3 scalings, 3 roundings, 3 subtractions, 3 scalings
back, 3 squares, 2 sums: 20; a general cell: 9 products and 6 sums each
way instead of the 6 scalings: 38), the root (1), the bin (2), the key
(2) and the count (1)."""

import numpy as np

KERNELS = ("rdf_blocked_kernel",)
OPS_ORTHO, OPS_GENERAL = 26, 44


def pairs_under_cut(out, piece):
    """Unordered pairs under the cut over the piece's frames, or None
    where the frames' volumes differ (the weights then do not factor)."""
    vols = np.abs(np.linalg.det(np.asarray(piece["cell"], np.float64)))
    if not np.allclose(vols, vols[0], rtol=1e-12, atol=0):
        return None
    return float(np.asarray(out["rdf_counts"], np.float64).sum()
                 / vols[0] / 2)


def work(out, piece, config=None, traffic=None, device=None):
    """(bytes, f32 operations) of the kernel over one unit, or None."""
    pairs = pairs_under_cut(out, piece)
    if pairs is None:
        return None
    cells = np.asarray(piece["cell"])
    f, n = piece["positions"].shape[:2]
    s, _, bins = np.asarray(out["rdf_counts"]).shape
    ortho = bool(np.all(cells == cells * np.eye(3)))
    ops = pairs * (OPS_ORTHO if ortho else OPS_GENERAL)
    return f * (16 * n + 72 + 4 * s * s * bins), ops
