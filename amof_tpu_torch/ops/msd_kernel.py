"""
Windowed MSD via FFT autocorrelation (Wiener-Khinchin).

Counterpart of ``amof_tpu/ops/msd_kernel.py``; replaces the reference's
O(N_frames x N_windows) rolling-sum loop (amof/msd.py:186-205):

    S(m) = sum_{k=0}^{T-m-1} |r_{k+m} - r_k|^2
         = S1(m) - 2 * AC(m),
    S1(m) = 2*Q - sum_{k<m} D_k - sum_{k>=T-m} D_k,   D_k = |r_k|^2,
    AC(m) = sum_k r_k . r_{k+m}   (via zero-padded rFFT, n = 2T)

The reference's estimator skips the k=0 origin for every window m>0 while
still dividing by (T-m). ``origin_policy='amof'`` reproduces that (the
|r_m - r_0|^2 term is subtracted); ``'standard'`` keeps all origins.
"""

from __future__ import annotations

import torch

from amof_tpu_torch.ops.pair_engine import inverse_cell, min_image_delta


def windowed_msd_atom_series(x, origin_policy: str = "amof"):
    """Per-atom sum over origins of |r_{k+m} - r_k|^2 for every m.

    x: float32 [T, A, 3] unwrapped positions. Returns float32 [T, A]
    (sum over atoms and divide by N * (T - m) for the MSD)."""
    t_len, a, _ = x.shape
    n_fft = 2 * t_len  # zero-pad for linear (non-circular) correlation
    d = torch.sum(x * x, dim=-1)  # [T, A]
    xf = torch.fft.rfft(x, n=n_fft, dim=0)
    ac = torch.fft.irfft(xf * torch.conj(xf), n=n_fft, dim=0)[:t_len]
    ac = torch.sum(ac, dim=-1)  # [T, A]
    q_tot = torch.sum(d, dim=0)  # [A]
    csum = torch.cumsum(d, dim=0)  # [T, A]
    m = torch.arange(t_len, device=x.device)
    head = torch.cat([torch.zeros((1, a), dtype=d.dtype, device=x.device),
                      csum[:-1]], dim=0)
    tail = q_tot[None, :] - csum[t_len - 1 - m]
    s = (2 * q_tot[None, :] - head - tail) - 2 * ac
    if origin_policy == "amof":
        # remove the k=0 origin pair (r_m vs r_0) the reference skips
        s = s - torch.sum((x - x[0][None]) ** 2, dim=-1)
    return s


def unwrap_positions(positions, cells, inv_cells=None):
    """Unwrapped positions from minimum-image consecutive displacements
    (amof/trajectory.py:285-303, amof/msd.py:222-230).

    positions: float32 [T, A, 3]; cells: float32 [T, 3, 3]."""
    if inv_cells is None:
        inv_cells = inverse_cell(cells)
    # each frame's displacement to the next, minimum-imaged in its cell
    delta = positions[1:] - positions[:-1]  # [T-1, A, 3]
    wrapped = min_image_delta(delta, cells[:-1, None], inv_cells[:-1, None])
    return torch.cat(
        [positions[:1], positions[:1] + torch.cumsum(wrapped, dim=0)], dim=0)


def remove_com_drift(positions, masses):
    """Subtract the mass-weighted center of mass of every frame
    (amof/msd.py:235-237)."""
    w = (masses / torch.sum(masses))[None, :, None]
    com = torch.sum(positions * w, dim=1, keepdim=True)
    return positions - com

