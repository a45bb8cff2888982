"""Traffic kind ``npt``: the fused step (``kinds/fused.py``) on pieces of a
flexible-cell (N,P,T) trajectory, where every frame has its own sheared,
breathing triclinic cell, as LAMMPS's ``fix npt ... tri`` and CP2K's
``NPT_F`` write them.

The harness draws each piece in the configuration's diagonal cell
(``network.py``); ``deformed`` maps it onto a cell a frame, affinely: the
fractional coordinates in the diagonal cell times the frame's cell, in
float64, then cast to float32. The cells follow LAMMPS's lower-triangular
convention, rows (lx, 0, 0), (xy, ly, 0), (xz, yz, lz), from the
configuration's ``npt`` block: per piece three static tilt angles, each
uniform in +-``static_tilt_deg`` (xy = ly tan, xz and yz = lz tan); per
frame three axis strains and three tilt fluctuations, each an
Ornstein-Uhlenbeck process of stationary ``strain_sigma`` or
``tilt_sigma_deg`` and correlation ``frame_correlation``. The cells are
drawn from a generator seeded by the bytes of the piece's frame 0, so the
unit, its reference and a fault's altered copy of the piece (which keeps
frame 0) get the same cells. A deformed piece is cached for as long as its
piece's positions array lives, so each distinct piece pays the map once.

Mix parameters: as ``fused``."""

from __future__ import annotations

import hashlib
import math
import weakref

import numpy as np

from bench_torch.harness import span
from bench_torch.kinds import fused
from bench_torch.reference import npt as ref_npt

REHEARSAL_FRAMES = 8

_DEFORMED = {}  # id(positions) -> the deformed piece


def frame_cells(piece, npt):
    """The piece's cells f64 [F, 3, 3], drawn from its frame 0."""
    pos, cell = piece["positions"], np.asarray(piece["cell"], np.float64)
    seed = hashlib.sha256(np.ascontiguousarray(pos[0]).tobytes()).digest()
    rng = np.random.default_rng(int.from_bytes(seed[:8], "little"))
    n_frames = len(pos)
    static = np.deg2rad(rng.uniform(-1, 1, 3) * npt["static_tilt_deg"])
    rho = float(npt["frame_correlation"])
    noise = rng.standard_normal((n_frames, 6))
    state = np.empty_like(noise)
    state[0] = noise[0]
    for f in range(1, n_frames):
        state[f] = rho * state[f - 1] + math.sqrt(1 - rho * rho) * noise[f]
    lengths = np.diagonal(cell, axis1=1, axis2=2) * (
        1 + npt["strain_sigma"] * state[:, :3])
    tilt = np.tan(static + np.deg2rad(npt["tilt_sigma_deg"]) * state[:, 3:])
    h = np.zeros((n_frames, 3, 3))
    h[:, 0, 0], h[:, 1, 1], h[:, 2, 2] = lengths.T
    h[:, 1, 0] = lengths[:, 1] * tilt[:, 0]   # xy
    h[:, 2, 0] = lengths[:, 2] * tilt[:, 1]   # xz
    h[:, 2, 1] = lengths[:, 2] * tilt[:, 2]   # yz
    return h


def deformed(piece, npt, device="cpu"):
    """``piece`` (diagonal cells) on its frames' triclinic cells: a new
    piece dict with positions f32 [F, N, 3] and cell f32 [F, 3, 3] on the
    host, the map computed in float64 on ``device``."""
    import torch

    pos = piece["positions"]
    got = _DEFORMED.get(id(pos))
    if got is not None and got[0]() is pos:
        return got[1]
    h = frame_cells(piece, npt)
    f64 = dict(dtype=torch.float64, device=device)
    diag = torch.as_tensor(
        np.diagonal(piece["cell"], axis1=1, axis2=2).copy(), **f64)
    frac = torch.as_tensor(pos, **f64) / diag[:, None, :]
    moved = torch.bmm(frac, torch.as_tensor(h, **f64)).float()
    out = dict(piece, positions=moved.cpu().numpy(),
               cell=h.astype(np.float32))
    key = id(pos)
    _DEFORMED[key] = (weakref.ref(pos), out)
    weakref.finalize(pos, _DEFORMED.pop, key, None)
    return out


class Runner(fused.Runner):
    """The fused kind's runner on ``deformed`` pieces. A program whose
    ``half_cell`` cut is not half the smallest width (the reference's
    range) cannot be compared on these cells: the run stops at its first
    unit, in set-up."""

    def __init__(self, config, traffic, device):
        super().__init__(config, traffic, device)
        self.npt = config["npt"]

    def unit(self, piece):
        piece = deformed(piece, self.npt, self.device)
        with span("fused.prepare"):
            step_fn, args, meta = self.fa.prepare(fused.batch_of(piece),
                                                  self.device)
        want = ref_npt.half_width(piece["cell"])
        if not math.isclose(meta["rmax"], want, rel_tol=1e-9):
            # ``prepare`` started the program's warmup, whose thread may be
            # building the kernels in nvcc processes that would outlive
            # this one: let them finish before the run stops
            from amof_tpu_torch.warmup import warmup

            warmup(block=True, device=self.device)
            raise SystemExit(
                f"npt: the program's half_cell cut is {meta['rmax']!r} A, "
                f"not half the smallest cell width ({want!r} A): past that "
                "width its RDF's minimum image is not exact on these cells")
        with span("fused.step"):
            return step_fn(*args)


def reference(config, traffic, piece, device, dtype=None):
    import torch

    a = traffic["analysis"]
    return ref_npt.analyses(
        deformed(piece, config["npt"], device), config["elements"],
        config["cutoffs_A"], config["rdf_dr_A"], config["bad_dtheta_deg"],
        dtype or torch.float64, device, with_bad=a.get("with_bad", True),
        with_msd=a.get("with_msd", True))


compare = fused.compare
