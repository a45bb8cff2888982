"""Plain PyTorch reference of aMOF's per-frame analyses: RDF pair
histograms, coordination counts, bond-angle histograms and the window MSD.

Written from aMOF's definitions (coudertlab/amof: rdf.py, cn.py, bad.py,
msd.py), not from the program: every pair of atoms by brute force in
blocks, minimum image by rounding fractional coordinates, float64 by
default. ``dtype`` lowers the precision for the control.

Definitions (S species in increasing atomic number, i != j):
  rdf[a, b, k]   sum over frames of V_f * #{(i in a, j in b):
                 k dr <= d_ij < (k + 1) dr}, k < bins
  cn[f, a, b]    #{(i in a, j in b): d_ij < cutoff(a, b)} in frame f
  neighbours     j is a neighbour of i when d_ij < cutoff(s_i, s_j)
  bad_concrete[a, b, 0, t]  angles j-i-k (j < k neighbours of a center
                 i of species a, both of species b) with floor(theta /
                 dtheta) = t, the last bin taking 180 degrees
  bad_center_any[a, 0, t]   every such angle at centers of species a
  msd[m], msd_species[m, s] positions less their mass-weighted centre
                 (per frame, as stored), unwrapped by minimum-image steps;
                 for m >= 1 the mean over atoms of
                 sum_{k=1}^{F-m-1} |u_{k+m} - u_k|^2 / (F - m) (aMOF skips
                 the k = 0 origin); msd[0] = 0
"""

from __future__ import annotations

import numpy as np
import torch

PAIR_BLOCK = 1 << 24  # (frame, row, column) entries a block


def species_table(species_z):
    """(sorted atomic numbers, species index i64 [N] on the host)."""
    unique = sorted(set(int(z) for z in species_z))
    lookup = {z: i for i, z in enumerate(unique)}
    return unique, np.array([lookup[int(z)] for z in species_z], np.int64)


def min_image(delta, cell, inv):
    """Cartesian minimum-image vectors; cell and inv broadcast as
    [..., 3, 3] against delta [..., M, 3]."""
    frac = delta @ inv
    return (frac - torch.round(frac)) @ cell


def cutoff_matrix(cutoffs, unique, symbols_to_z):
    s = len(unique)
    cut = np.zeros((s, s))
    for pair, r in cutoffs.items():
        a, b = (unique.index(symbols_to_z[x]) for x in pair.split("-"))
        cut[a, b] = cut[b, a] = r
    return cut


def _blocks(n_frames, n):
    """(frame block, row block) sizes with about PAIR_BLOCK entries."""
    per_frame = n * n
    if per_frame >= PAIR_BLOCK:
        return 1, max(1, PAIR_BLOCK // n)
    return max(1, PAIR_BLOCK // per_frame), n


def pair_pass(positions, cells, sp, n_species, dr, bins, cut, dtype,
              device, on_neighbours):
    """The volume-weighted RDF histogram f64 [S, S, bins] and the
    neighbour lists: ``on_neighbours(frames, i, j, vec)`` is called once
    per frame block with every (frame, center, neighbour, minimum-image
    vector from center to neighbour) of the block."""
    f_all, n, _ = positions.shape
    pos_all = torch.as_tensor(positions, device=device).to(dtype)
    cell_all = torch.as_tensor(cells, device=device).to(dtype)
    inv_all = torch.linalg.inv(torch.as_tensor(cells, dtype=torch.float64,
                                               device=device)).to(dtype)
    vol_all = torch.linalg.det(torch.as_tensor(
        cells, dtype=torch.float64, device=device)).abs()
    spd = torch.as_tensor(sp, device=device)
    cut2 = torch.as_tensor(cut, device=device).to(dtype) ** 2
    drt = torch.tensor(dr, dtype=dtype, device=device)
    hist = torch.zeros(n_species * n_species * bins, dtype=torch.float64,
                       device=device)
    fb, rb = _blocks(f_all, n)
    cols = torch.arange(n, device=device)
    for f0 in range(0, f_all, fb):
        f1 = min(f0 + fb, f_all)
        pos = pos_all[f0:f1]
        cell = cell_all[f0:f1, None]
        inv = inv_all[f0:f1, None]
        found = []
        for i0 in range(0, n, rb):
            i1 = min(i0 + rb, n)
            delta = pos[:, None, :, :] - pos[:, i0:i1, None, :]
            vec = min_image(delta, cell, inv)  # [fb, rb, N, 3]
            d2 = (vec * vec).sum(-1)
            rows = torch.arange(i0, i1, device=device)
            other = rows[:, None] != cols[None, :]
            si, sj = spd[i0:i1, None], spd[None, :]
            k = torch.floor(torch.sqrt(d2) / drt)
            keep = other & (k < bins)
            key = (si * n_species + sj) * bins + k.to(torch.int64)
            w = vol_all[f0:f1, None, None].expand_as(d2)
            hist += torch.bincount(key[keep], weights=w[keep],
                                   minlength=hist.numel())
            near = other & (d2 < cut2[si, sj])
            ff, ii, jj = torch.nonzero(near, as_tuple=True)
            found.append((ff + f0, ii + i0, jj, vec[ff, ii, jj]))
            del delta, vec, d2, k, keep, key, w, near
        on_neighbours(*(torch.cat(x) for x in zip(*found)))
    return hist.reshape(n_species, n_species, bins)


def angle_counts(frames, centers, nbrs, vec, sp, n_species, dtheta,
                 bad_bins, n_atoms, conc, any_):
    """Adds the bond angles of the given neighbour lists into ``conc``
    f64 [S*S*bins] and ``any_`` f64 [S*bins]."""
    if frames.numel() == 0:
        return
    dev = vec.device
    key = frames * n_atoms + centers
    order = torch.argsort(key, stable=True)
    key, nbrs, vec = key[order], nbrs[order], vec[order]
    _, counts = torch.unique_consecutive(key, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    group = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                    counts)
    rank = torch.arange(len(key), device=dev) - starts[group]
    deg = int(counts.max())
    if deg < 2:
        return
    slots = torch.zeros((len(counts), deg, 3), dtype=vec.dtype, device=dev)
    s_nb = torch.full((len(counts), deg), -1, dtype=torch.int64, device=dev)
    slots[group, rank] = vec
    s_nb[group, rank] = sp[nbrs]
    center_sp = sp[key[starts] % n_atoms]
    kk, ll = torch.triu_indices(deg, deg, 1, device=dev)
    tiny = torch.finfo(slots.dtype).tiny  # coincident atoms: cos 0
    unit = slots / torch.linalg.vector_norm(slots, dim=-1,
                                            keepdim=True).clamp_min(tiny)
    cos = (unit[:, kk] * unit[:, ll]).sum(-1)
    theta = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
    dth = torch.tensor(dtheta, dtype=theta.dtype, device=dev)
    t = torch.floor(theta / dth).to(torch.int64).clamp(0, bad_bins - 1)
    sk, sl = s_nb[:, kk], s_nb[:, ll]
    a = center_sp[:, None].expand_as(sk)
    valid = (sk >= 0) & (sl >= 0)
    same = valid & (sk == sl)
    conc += torch.bincount(((a * n_species + sk) * bad_bins + t)[same],
                           minlength=conc.numel()).to(torch.float64)
    any_ += torch.bincount((a * bad_bins + t)[valid],
                           minlength=any_.numel()).to(torch.float64)


def msd_series(positions, cells, sp, masses, n_species, dtype, device):
    """(msd f64 [F], msd_species f64 [F, S]) by aMOF's estimator."""
    f_all, n, _ = positions.shape
    x = torch.as_tensor(positions, device=device).to(dtype)
    cell = torch.as_tensor(cells, device=device).to(dtype)
    inv = torch.linalg.inv(torch.as_tensor(cells, dtype=torch.float64,
                                           device=device)).to(dtype)
    m = torch.as_tensor(masses, device=device).to(dtype)
    com = (x * m[None, :, None]).sum(1) / m.sum()
    x = x - com[:, None, :]
    step = min_image(x[1:] - x[:-1], cell[:-1], inv[:-1])
    u = torch.cat([x[:1], x[:1] + torch.cumsum(step, dim=0)])
    spd = torch.as_tensor(sp, device=device)
    n_sp = torch.bincount(spd, minlength=n_species).to(torch.float64)
    msd = torch.zeros(f_all, dtype=torch.float64, device=device)
    msd_sp = torch.zeros((f_all, n_species), dtype=torch.float64,
                         device=device)
    for lag in range(1, f_all - 1):
        d = u[lag + 1:] - u[1:f_all - lag]
        per_atom = (d * d).sum(-1).sum(0).to(torch.float64)
        sums = torch.zeros(n_species, dtype=torch.float64, device=device)
        sums.index_add_(0, spd, per_atom)
        msd_sp[lag] = sums / (n_sp * (f_all - lag))
        msd[lag] = sums.sum() / (n * (f_all - lag))
    return msd, msd_sp


def analyses(piece, elements, cutoffs, dr, dtheta, dtype=torch.float64,
             device="cpu", with_bad=True, with_msd=True):
    """The fused step's outputs on one trajectory piece (host arrays
    ``positions``, ``cell``, ``species``): a dict of numpy arrays with the
    program's keys and shapes."""
    positions, cells = piece["positions"], piece["cell"]
    f_all, n, _ = positions.shape
    sym_to_z = {s: e["Z"] for s, e in elements.items()}
    z_to_mass = {e["Z"]: e["mass_amu"] for e in elements.values()}
    unique, sp = species_table(piece["species"])
    s = len(unique)
    lengths = np.linalg.norm(np.asarray(cells, np.float64), axis=2)
    bins = int((float(lengths.min()) / 2) // dr)
    bad_bins = int(180 // dtheta) + 1
    cut = cutoff_matrix(cutoffs, unique, sym_to_z)
    spd = torch.as_tensor(sp, device=device)
    cn = torch.zeros((f_all, s, s), dtype=torch.float64, device=device)
    conc = torch.zeros(s * s * bad_bins, dtype=torch.float64, device=device)
    any_ = torch.zeros(s * bad_bins, dtype=torch.float64, device=device)

    def on_neighbours(fr, ci, nj, vec):
        cn.view(-1).index_add_(
            0, (fr * s + spd[ci]) * s + spd[nj],
            torch.ones(len(fr), dtype=torch.float64, device=device))
        if with_bad:
            angle_counts(fr, ci, nj, vec, spd, s, dtheta, bad_bins, n,
                         conc, any_)

    rdf = pair_pass(positions, cells, sp, s, dr, bins, cut, dtype, device,
                    on_neighbours)
    out = {"rdf_counts": rdf, "cn_counts": cn,
           "bad_concrete": conc.reshape(s, s, 1, bad_bins),
           "bad_center_any": any_.reshape(s, 1, bad_bins)}
    if with_msd:
        masses = np.array([z_to_mass[int(z)] for z in piece["species"]])
        out["msd"], out["msd_species"] = msd_series(
            positions, cells, sp, masses, s, dtype, device)
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The numbers ``correct`` compares
# ---------------------------------------------------------------------------

def l1_share(got, ref):
    """sum |got - ref| / sum |ref|: the share of counts binned otherwise
    (inf where the shapes differ)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    return float(np.abs(got - ref).sum() / max(np.abs(ref).sum(), 1e-300))


def frame_l1_share(got, ref):
    """The largest per-frame ``l1_share`` over the first axis."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    return max(l1_share(g, r) for g, r in zip(got, ref))


def max_rel(got, ref, lags):
    """Largest |got - ref| / |ref| over ``lags`` of the first axis."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    g, r = got[lags], ref[lags]
    return float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-300)))
