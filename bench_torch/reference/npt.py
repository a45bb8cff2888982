"""Plain PyTorch reference of the fused step's outputs on a piece of a
flexible-cell (N,P,T) trajectory, where every frame has its own
triclinic cell.

The passes are ``reference/fused.py``'s (imported): every pair by brute
force, minimum image by rounding fractional coordinates, float64 by
default (``dtype`` lowers it for the control). The one difference is
the RDF's range: ``bins`` from half the smallest perpendicular width
over the frames' cells, below which the rounding finds the nearest
image (a pair nearer than half the width has fractional separations
under 1/2 along every axis). The fused reference's rule, half the
smallest length, lies past that on a sheared cell. Imports no program
code.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import fused as ref_fused


def half_width(cells):
    """Half the smallest perpendicular width of the cells [F, 3, 3] over
    the frames and axes (float64): |a . (b x c)| / |b x c| for a."""
    h = np.asarray(cells, np.float64).reshape(-1, 3, 3)
    widths = []
    for a in range(3):
        cross = np.cross(h[:, (a + 1) % 3], h[:, (a + 2) % 3])
        widths.append(np.abs(np.einsum("fi,fi->f", h[:, a], cross))
                      / np.linalg.norm(cross, axis=1))
    return float(np.min(widths)) / 2


def analyses(piece, elements, cutoffs, dr, dtheta, dtype=torch.float64,
             device="cpu", with_bad=True, with_msd=True):
    """The fused step's outputs on one piece (host arrays ``positions``,
    ``cell`` [F, 3, 3], ``species``): a dict of numpy arrays with the
    program's keys and shapes (``reference/fused.py``'s definitions)."""
    positions, cells = piece["positions"], piece["cell"]
    f_all, n, _ = positions.shape
    sym_to_z = {s: e["Z"] for s, e in elements.items()}
    z_to_mass = {e["Z"]: e["mass_amu"] for e in elements.values()}
    unique, sp = ref_fused.species_table(piece["species"])
    s = len(unique)
    bins = int(half_width(cells) // dr)
    bad_bins = int(180 // dtheta) + 1
    cut = ref_fused.cutoff_matrix(cutoffs, unique, sym_to_z)
    spd = torch.as_tensor(sp, device=device)
    cn = torch.zeros((f_all, s, s), dtype=torch.float64, device=device)
    conc = torch.zeros(s * s * bad_bins, dtype=torch.float64, device=device)
    any_ = torch.zeros(s * bad_bins, dtype=torch.float64, device=device)

    def on_neighbours(fr, ci, nj, vec):
        cn.view(-1).index_add_(
            0, (fr * s + spd[ci]) * s + spd[nj],
            torch.ones(len(fr), dtype=torch.float64, device=device))
        if with_bad:
            ref_fused.angle_counts(fr, ci, nj, vec, spd, s, dtheta,
                                   bad_bins, n, conc, any_)

    rdf = ref_fused.pair_pass(positions, cells, sp, s, dr, bins, cut, dtype,
                              device, on_neighbours)
    out = {"rdf_counts": rdf, "cn_counts": cn,
           "bad_concrete": conc.reshape(s, s, 1, bad_bins),
           "bad_center_any": any_.reshape(s, 1, bad_bins)}
    if with_msd:
        masses = np.array([z_to_mass[int(z)] for z in piece["species"]])
        out["msd"], out["msd_species"] = ref_fused.msd_series(
            positions, cells, sp, masses, s, dtype, device)
    return {k: v.cpu().numpy() for k, v in out.items()}
