"""Plain PyTorch reference of aMOF's per-analysis results: the columns of
``Rdf``, ``CoordinationNumber``, ``Bad`` and ``WindowMsd``
(coudertlab/amof: rdf.py, cn.py, bad.py, msd.py) on one trajectory
piece.

The counts are ``reference/fused.py``'s (every pair by brute force,
float64 by default; ``dtype`` lowers the precision for the control).
The normalisations are aMOF's, written from its definitions:
  g_AB(r_k)   C_AB(k) / (F * N_A * N * v_k), C_AB the pair counts weighted
              by each frame's volume V_f (the density N / V_f), v_k the
              shell volume 4 pi / 3 ((k + 1)^3 - k^3) dr^3; "X-X" over all
              pairs with N_A = N; "A-X" the sum of A's partials
  CN          per frame, the neighbours of species B a centre of species A
              has within the cutoff, averaged over the A centres
  BAD         for each (centre, outer) spec of aMOF's enumeration (the
              species the cutoffs name, "X" where they name all), the
              angle histogram divided by its total and dtheta
  MSD         aMOF's windowed estimator at the given lags, per species
              and over all atoms ("X")
"""

from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference import fused as ref_fused


def rdf_columns(counts, species, unique, sym, n_frames, dr):
    counts = np.asarray(counts, np.float64)
    bins = counts.shape[-1]
    edges = np.arange(bins + 1) * dr
    shell = 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)
    n = len(species)
    n_a = [float((species == z).sum()) for z in unique]
    cols = {"r": np.arange(bins) * dr,
            "X-X": counts.sum(axis=(0, 1)) / (n_frames * n * n * shell)}
    for a, za in enumerate(unique):
        for b, zb in enumerate(unique):
            cols[f"{sym[za]}-{sym[zb]}"] = counts[a, b] / (
                n_frames * n_a[a] * n * shell)
    for a, za in enumerate(unique):
        cols[f"{sym[za]}-X"] = sum(cols[f"{sym[za]}-{sym[zb]}"]
                                   for zb in unique)
    return cols


def cn_columns(cn, species, unique, sym_to_z, cutoffs, step):
    cols = {"Step": np.asarray(step)}
    for pair in cutoffs:
        a, b = (unique.index(sym_to_z[s]) for s in pair.split("-"))
        cols[pair] = np.asarray(cn)[:, a, b] / float(
            (species == unique[a]).sum())
    return cols


def bad_specs(cutoffs, unique, sym_to_z):
    """aMOF's (centre, outer) enumeration (amof/bad.py): the species the
    cutoffs name, then "X" where they name every species present;
    centre and outer differ, except ("X", "X")."""
    named = sorted({sym_to_z[s] for pair in cutoffs for s in pair.split("-")})
    epu = list(named) + (["X"] if len(named) == len(unique) else [])
    return [(a, b) for b in epu for a in epu
            if a not in (b, "X") or (a, b) == ("X", "X")]


def bad_columns(conc, any_, unique, sym, sym_to_z, cutoffs, dtheta):
    conc = np.asarray(conc, np.float64)[:, :, 0]   # [centre, outer, bins]
    any_ = np.asarray(any_, np.float64)[:, 0]      # [centre, bins]
    bins = int(180 // dtheta)
    cols = {"theta": np.arange(bins + 1) * dtheta + dtheta / 2}
    for a, b in bad_specs(cutoffs, unique, sym_to_z):
        if a == "X":
            hist = any_.sum(axis=0)
        elif b == "X":
            hist = any_[unique.index(a)]
        else:
            hist = conc[unique.index(a), unique.index(b)]
        total = hist.sum()
        if total > 0:
            name = "-".join(("X" if x == "X" else sym[x]) for x in (b, a, b))
            cols[name] = hist / (total * dtheta)
    return cols


def msd_columns(msd, msd_species, unique, sym, lags, step):
    cols = {"Time": np.asarray(step)[lags]}
    for s, z in enumerate(unique):
        cols[sym[z]] = np.asarray(msd_species)[lags, s]
    cols["X"] = np.asarray(msd)[lags]
    return cols


def columns(piece, elements, cutoffs, dr, dtheta, lags,
            dtype=torch.float64, device="cpu"):
    """The four analyses' columns on one piece (host arrays
    ``positions``, ``cell``, ``species``, ``step``): a dict ``rdf``,
    ``cn``, ``bad``, ``msd`` of {column: numpy array}."""
    sym_to_z = {s: e["Z"] for s, e in elements.items()}
    sym = {z: s for s, z in sym_to_z.items()}
    species = np.asarray(piece["species"])
    unique, _ = ref_fused.species_table(species)
    counts = ref_fused.analyses(piece, elements, cutoffs, dr, dtheta, dtype,
                                device)
    n_frames = len(piece["step"])
    return {
        "rdf": rdf_columns(counts["rdf_counts"], species, unique, sym,
                           n_frames, dr),
        "cn": cn_columns(counts["cn_counts"], species, unique, sym_to_z,
                         cutoffs, piece["step"]),
        "bad": bad_columns(counts["bad_concrete"], counts["bad_center_any"],
                           unique, sym, sym_to_z, cutoffs, dtheta),
        "msd": msd_columns(counts["msd"], counts["msd_species"], unique, sym,
                           lags, piece["step"]),
    }


# ---------------------------------------------------------------------------
# The numbers ``correct`` compares
# ---------------------------------------------------------------------------

def _stack(got, ref, axis):
    """(got, ref) value columns stacked [columns, rows] in the reference's
    order, or None where the column names or the axis column differ."""
    if set(got) != set(ref) or not np.allclose(
            np.asarray(got[axis], np.float64), np.asarray(ref[axis],
                                                          np.float64),
            rtol=1e-12, atol=0):
        return None
    names = [k for k in ref if k != axis]
    try:
        return (np.stack([np.asarray(got[k], np.float64) for k in names]),
                np.stack([np.asarray(ref[k], np.float64) for k in names]))
    except ValueError:  # a column of another length
        return None


def compare(out, ref):
    """rdf_l1, cn_frame_l1 and bad_l1 (L1 shares over all columns; CN's
    worst frame) and msd_rel (the largest relative error over every lag
    but 0); inf where the program's columns differ in name or axis."""
    nums = {}
    for key, axis, name in (("rdf", "r", "rdf_l1"), ("cn", "Step",
                                                     "cn_frame_l1"),
                            ("bad", "theta", "bad_l1"), ("msd", "Time",
                                                         "msd_rel")):
        pair = _stack(out[key], ref[key], axis)
        if pair is None:
            nums[name] = float("inf")
        elif name == "cn_frame_l1":
            nums[name] = ref_fused.frame_l1_share(pair[0].T, pair[1].T)
        elif name == "msd_rel":
            nums[name] = ref_fused.max_rel(pair[0].T, pair[1].T,
                                           slice(1, None))
        else:
            nums[name] = ref_fused.l1_share(*pair)
    return nums
