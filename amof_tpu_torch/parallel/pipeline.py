"""
Fused RDF + CN (+ BAD) (+ MSD) step on one device: the flagship step.

Counterpart of ``amof_tpu/parallel/pipeline.py`` ``FusedAnalysis``. One
pass over the trajectory computes

  * RDF species-pair histograms, volume-weighted (kernel #1 on the
    species-blocked layout, kernel #2 otherwise),
  * per-frame CN counts, read off the BAD neighbour table,
  * BAD angle histograms from the K-slot neighbour table (kernel #3 on
    2-level slab windows, kernel #4 on the 1-level window, the full table
    last),
  * windowed MSD via FFT, in atom blocks.

Frames run in a loop on the device; frame sums accumulate in float64 on
the device (the JAX package's Neumaier carries existed only because f64
is slow on a TPU). There is no mesh: the step is single-device.

A frame whose neighbour table overflowed K (or whose window missed)
contributes nothing to the BAD histograms in its first pass and is rerun
at doubled capacity, so no angle is ever dropped silently.
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amof_tpu_torch.bad import _enumerate_specs
from amof_tpu_torch.cn import _cutoff_matrix_for_species
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import bad_kernel, msd_kernel, pair_engine, rdf_kernel
from amof_tpu_torch.rdf import _species_table

logger = logging.getLogger(__name__)

MAX_RERUN_CAPACITY = 1024  # the retry ladder's K bound


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises for CUDA without a card (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


class StepArgs(NamedTuple):
    """Device-resident inputs of the fused step."""
    positions: torch.Tensor  # f32 [F, N', 3] (padded / species-blocked)
    cells: torch.Tensor      # f32 [F, 3, 3]
    inv_cells: torch.Tensor  # f32 [F, 3, 3]
    volumes: torch.Tensor    # f32 [F]
    species_idx: torch.Tensor  # i32 [N'] (-1 pads)
    cutoff_matrix: torch.Tensor  # f32 [S, S]
    masses: torch.Tensor     # f32 [N'] (0 for pads)


class _Config(NamedTuple):
    n_species: int
    bins: int
    dr: float
    bad_bins: int
    dtheta: float
    chunk: int
    blocked: bool
    ortho: bool
    bad_window: Optional[int]
    bad_slab: object  # slab_table.SlabPlan or None
    with_bad: bool


def _first_rung(cfg: _Config) -> str:
    if cfg.bad_slab is not None:
        return "slab"
    return "window" if cfg.bad_window is not None else "full"


def _frame_pass(cfg: _Config, a: StepArgs, f: int, k_cap: int,
                with_rdf: bool = True, rung: str = "slab"):
    """One frame: (weighted RDF f32[S,S,bins] or None, CN f32[S,S],
    BAD concrete, BAD center_any, flag bool[], window missed bool[] or
    None)."""
    pos, cell, inv = a.positions[f], a.cells[f], a.inv_cells[f]
    s = cfg.n_species
    rdf = None
    if with_rdf:
        rdf = a.volumes[f] * pair_engine.frame_rdf_counts(
            pos, cell, a.species_idx, cfg.dr, s, cfg.bins,
            blocked=cfg.blocked, ortho=cfg.ortho, inv_cell=inv,
        )
    if not cfg.with_bad:
        cn = pair_engine.frame_cn_counts(
            pos, cell, a.species_idx, a.cutoff_matrix, s, cfg.chunk,
            inv_cell=inv,
        )
        return rdf, cn, None, None, torch.zeros((), dtype=torch.bool,
                                                device=pos.device), None
    bad_c, bad_a, flag, cn, missed = bad_kernel.frame_bad_counts(
        pos, cell, a.species_idx, a.cutoff_matrix, s, cfg.dtheta,
        cfg.bad_bins, k_cap, cfg.chunk,
        window=cfg.bad_window if rung in ("slab", "window") else None,
        emit_cn=True, slab=cfg.bad_slab if rung == "slab" else None,
        inv_cell=inv, emit_missed=True,
    )
    return rdf, cn, bad_c, bad_a, flag, missed


class _Sums:
    """float64 device accumulators of the frame sums."""

    def __init__(self, cfg: _Config, n_frames: int, device):
        s, dev = cfg.n_species, device
        self.rdf = torch.zeros((s, s, cfg.bins), dtype=torch.float64,
                               device=dev)
        shape_c = (s, s, 1, cfg.bad_bins) if cfg.with_bad else (1,)
        shape_a = (s, 1, cfg.bad_bins) if cfg.with_bad else (1,)
        self.bad_c = torch.zeros(shape_c, dtype=torch.float64, device=dev)
        self.bad_a = torch.zeros(shape_a, dtype=torch.float64, device=dev)
        self.cn = torch.zeros((n_frames, s, s), dtype=torch.float32,
                              device=dev)
        self.flag = torch.zeros(n_frames, dtype=torch.bool, device=dev)

    def add_bad(self, bad_c, bad_a, flag):
        # a flagged frame contributes NOTHING (self-masked, no host sync)
        keep = (~flag).to(torch.float64)
        self.bad_c += bad_c.to(torch.float64) * keep
        self.bad_a += bad_a.to(torch.float64) * keep

    def add(self, f, out, with_rdf=True):
        rdf, cn, bad_c, bad_a, flag, _ = out
        if with_rdf:
            self.rdf += rdf.to(torch.float64)
        self.cn[f] = cn
        self.flag[f] = flag
        if bad_c is not None:
            self.add_bad(bad_c, bad_a, flag)


def _msd_atom_block(n_frames: int, n_pad: int,
                    msd_atoms_per_call: Optional[int]) -> int:
    """Atom block: divides the padded atom count; auto-sizing targets
    ~256 MB of series (F x A_blk x 3 f32 x a few live copies)."""
    a_target = msd_atoms_per_call or int(max(
        1, min(n_pad, 256e6 // (12 * n_frames))
    ))
    for d in range(min(a_target, n_pad), 0, -1):
        if n_pad % d == 0:
            return d
    return 1


def _msd(a: StepArgs, n_species: int, origin_policy: str, a_blk: int):
    """(msd f32[F], msd_species f32[F, S]) in atom blocks of ``a_blk``.

    Reference order (amof/msd.py:235-247): COM removal on the stored
    positions, THEN min-image displacement decomposition."""
    n_frames, n_pad, _ = a.positions.shape
    dev = a.positions.device
    m64 = a.masses.to(torch.float64)
    com = torch.zeros((n_frames, 3), dtype=torch.float64, device=dev)
    for b in range(0, n_pad, a_blk):
        com += torch.einsum("fai,a->fi",
                            a.positions[:, b:b + a_blk].to(torch.float64),
                            m64[b:b + a_blk])
    com = (com / m64.sum()).to(torch.float32)
    sums = torch.zeros((n_frames, n_species), dtype=torch.float64,
                       device=dev)
    n_sp = torch.zeros(n_species, dtype=torch.float64, device=dev)
    for b in range(0, n_pad, a_blk):
        sp = a.species_idx[b:b + a_blk].long()
        real = a.masses[b:b + a_blk] > 0
        x = msd_kernel.unwrap_positions(
            a.positions[:, b:b + a_blk] - com[:, None, :], a.cells,
            a.inv_cells,
        )
        x = x * real[None, :, None]  # padding atoms add no displacement
        s = msd_kernel.windowed_msd_atom_series(x, origin_policy)
        sums.index_add_(1, sp[real], s[:, real].to(torch.float64))
        n_sp += torch.bincount(sp[real], minlength=n_species)
    origins = (n_frames - torch.arange(n_frames, device=dev)).to(
        torch.float64)
    msd_sp = sums / (n_sp[None, :] * origins[:, None])
    msd = sums.sum(dim=1) / (n_sp.sum() * origins)
    msd_sp[0] = 0.0
    msd[0] = 0.0
    return msd.to(torch.float32), msd_sp.to(torch.float32)


class FusedAnalysis:
    """Configurable fused RDF+CN(+BAD)(+MSD) step on one device.

    ``frames_per_call`` groups frames (the chunked step): a group where
    more than half the frames overflow K is rerun whole at doubled K
    (remembered for the group); single flagged frames rerun alone at
    doubled K on the 1-level window, then on the full table when the
    window itself missed. MSD then runs in atom blocks of
    ``msd_atoms_per_call`` atoms. Without ``frames_per_call`` the step is
    one pass with no reruns: flagged frames are reported in
    ``bad_overflow`` and left out of the BAD histograms.
    """

    def __init__(
        self,
        nb_set_and_cutoff,
        dr: float = 0.02,
        rmax: Optional[float] = None,
        dtheta: float = 1.0,
        max_neighbors: int = 16,
        with_bad: bool = True,
        with_msd: bool = True,
        chunk: int = 256,
        origin_policy: str = "amof",
        bad_window="auto",
        frames_per_call: Optional[int] = None,
        msd_atoms_per_call: Optional[int] = None,
    ):
        self.nb_set_and_cutoff = nb_set_and_cutoff
        self.dr = dr
        self.rmax = rmax
        self.dtheta = dtheta
        self.max_neighbors = max_neighbors
        self.with_bad = with_bad
        self.with_msd = with_msd
        self.chunk = chunk
        self.origin_policy = origin_policy
        # "auto" sizes the window from the density and max cutoff; None
        # forces the full O(N^2) table; an int is used as-is
        self.bad_window = bad_window
        self.frames_per_call = frames_per_call
        self.msd_atoms_per_call = msd_atoms_per_call

    def prepare(self, batch, device="cuda"):
        """Resolve static shapes, lay atoms out and upload them; returns
        (step_fn, args, meta). ``step_fn(*args)`` runs the step."""
        from amof_tpu_torch.ops import slab_table

        dev = resolve_device(device)
        batch = as_frame_batch(batch)
        species = np.asarray(batch.species)
        unique, z_to_idx = _species_table(species)
        n_species = len(unique)

        cells = np.asarray(batch.cell, dtype=np.float32)
        lengths = np.linalg.norm(cells.astype(np.float64), axis=2)
        rmax = self.rmax or float(lengths.min()) / 2
        bins = int(rmax // self.dr)

        # species-blocked layout upgrades RDF to kernel #1 (histograms are
        # permutation-invariant, so BAD/CN/MSD take the re-layout
        # unchanged); skipped when per-species padding to 256-atom tiles
        # would inflate the atom count past 1.5x
        block = int(np.lcm(256, self.chunk))
        perm, sp_l = rdf_kernel.species_block_layout(
            z_to_idx[species], block=block, total_multiple=block
        )
        blocked = len(sp_l) <= 1.5 * len(species)
        if blocked:
            positions = rdf_kernel.apply_atom_layout(
                np.asarray(batch.positions, np.float32), perm)
            species_idx = sp_l.astype(np.int32)
        else:
            positions, species_idx = pair_engine.pad_atoms(
                np.asarray(batch.positions, np.float32),
                z_to_idx[species].astype(np.int32), self.chunk,
            )

        cutoff_matrix = _cutoff_matrix_for_species(
            self.nb_set_and_cutoff, unique, z_to_idx
        )
        pairs, bad_names = _enumerate_specs(self.nb_set_and_cutoff, unique)
        bad_specs = tuple(
            (
                -1 if sa == "X" else int(z_to_idx[sa]),
                -1 if sb == "X" else int(z_to_idx[sb]),
            )
            for sa, sb in pairs
        )
        bad_bins = int(180 // self.dtheta) + 1
        # per-slot masses (pads may be interleaved by the blocked layout)
        z_slot = np.asarray(unique)[np.maximum(species_idx, 0)]
        masses = np.where(
            species_idx >= 0, elements.mass_of(z_slot), 0.0
        ).astype(np.float32)
        volumes = np.abs(np.linalg.det(cells.astype(np.float64))).astype(
            np.float32)

        n_pad = positions.shape[1]
        bad_window = self.bad_window
        if bad_window == "auto":
            rc = float(cutoff_matrix.max())
            # slab width along fractional axis 0: V / |b x c| (min frame)
            bxc = np.cross(cells[:, 1].astype(np.float64),
                           cells[:, 2].astype(np.float64))
            v = np.abs(np.einsum("fi,fi->f", cells[:, 0].astype(np.float64),
                                 bxc))
            w0 = float((v / np.linalg.norm(bxc, axis=1)).min())
            # pad rows carry uniformly-spread sort keys, so the window
            # scales with the PADDED atom count
            est = 1.6 * n_pad * 2.0 * rc / max(w0, 1e-9) + 64
            bad_window = int(-(-est // 128) * 128)
        if bad_window is not None and self.chunk + 2 * bad_window >= n_pad:
            bad_window = None

        # 2-level (slab, y) windows for the BAD/CN table: ~3x fewer
        # candidate tests than the 1-level x-window
        bad_slab = None
        if self.with_bad and bad_window is not None:
            bad_slab = slab_table.slab_plan(
                cells, float(cutoff_matrix.max()), n_pad,
                positions=positions, species_idx=species_idx,
            )

        # diagonal-cell certificate for the RDF kernels' fast path
        ortho = bool(np.all(cells == cells * np.eye(3, dtype=cells.dtype)))

        cells_t = torch.from_numpy(np.ascontiguousarray(cells))
        args = StepArgs(
            positions=torch.from_numpy(positions).to(dev),
            cells=cells_t.to(dev),
            inv_cells=pair_engine.inverse_cell(cells_t).to(dev),
            volumes=torch.from_numpy(volumes).to(dev),
            species_idx=torch.from_numpy(species_idx).to(dev),
            cutoff_matrix=torch.from_numpy(cutoff_matrix).to(dev),
            masses=torch.from_numpy(masses).to(dev),
        )
        cfg = _Config(
            n_species=n_species, bins=bins, dr=float(self.dr),
            bad_bins=bad_bins, dtheta=float(self.dtheta), chunk=self.chunk,
            blocked=blocked, ortho=ortho, bad_window=bad_window,
            bad_slab=bad_slab, with_bad=self.with_bad,
        )
        meta = {
            "unique": unique, "bins": bins, "rmax": rmax,
            "bad_names": bad_names, "bad_specs": bad_specs, "device": dev,
            "blocked": blocked, "ortho": ortho, "bad_window": bad_window,
            "bad_slab": bad_slab, "n_atoms_padded": n_pad,
        }
        a_blk = _msd_atom_block(batch.num_frames, n_pad,
                                self.msd_atoms_per_call)
        if self.frames_per_call is not None:
            step_fn = self._make_chunked_step(cfg, meta, a_blk)
        else:
            step_fn = self._make_step(cfg, n_pad)
        return step_fn, args, meta

    def _finish(self, a: StepArgs, sums: _Sums, n_species: int, a_blk: int):
        out = {
            "rdf_counts": sums.rdf,
            "cn_counts": sums.cn,
            "bad_concrete": sums.bad_c,
            "bad_center_any": sums.bad_a,
            # per-frame flags: nonzero => some atom of that frame had
            # > K neighbours within cutoff (or a window missed) and the
            # frame's angles are NOT in the BAD histograms
            "bad_overflow": sums.flag,
        }
        if self.with_msd:
            out["msd"], out["msd_species"] = _msd(
                a, n_species, self.origin_policy, a_blk)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _make_step(self, cfg: _Config, n_pad: int):
        """Monolithic step: every frame once at ``max_neighbors``."""
        def step(*args):
            a = StepArgs(*args)
            sums = _Sums(cfg, a.positions.shape[0], a.positions.device)
            rung = _first_rung(cfg)
            for f in range(a.positions.shape[0]):
                sums.add(f, _frame_pass(cfg, a, f, self.max_neighbors,
                                        rung=rung))
            return self._finish(a, sums, cfg.n_species, n_pad)

        return step

    def _make_chunked_step(self, cfg: _Config, meta, a_blk: int):
        """Grouped step: ``frames_per_call`` frames per group, whole-group
        K doubling when more than half a group flags, then per-frame
        reruns of the flagged frames (RDF skipped: it never uses the
        neighbour table) up the ladder 1-level window -> full table with
        doubling K. Capacities found per group are remembered across
        calls (they are a property of the data)."""
        group_caps = {}
        meta["msd_atoms_per_call"] = a_blk

        def chunked_step(*args):
            a = StepArgs(*args)
            n_frames = a.positions.shape[0]
            target = max(self.frames_per_call, 1)
            fpc = next(d for d in range(min(target, n_frames), 0, -1)
                       if n_frames % d == 0)
            meta["frames_per_call"] = fpc
            sums = _Sums(cfg, n_frames, a.positions.device)
            rung0 = _first_rung(cfg)
            for i in range(0, n_frames, fpc):
                k_cap = group_caps.get(i, self.max_neighbors)
                outs = [_frame_pass(cfg, a, f, k_cap, rung=rung0)
                        for f in range(i, i + fpc)]
                for out in outs:
                    sums.rdf += out[0].to(torch.float64)
                if cfg.with_bad:
                    flags = torch.stack([o[4] for o in outs])
                    # dense overflow: this data genuinely needs a bigger
                    # table -- escalate the whole group (BAD/CN only)
                    while (int(flags.sum()) > fpc // 2
                           and k_cap < MAX_RERUN_CAPACITY):
                        k_cap *= 2
                        group_caps[i] = k_cap
                        outs = [_frame_pass(cfg, a, f, k_cap,
                                            with_rdf=False, rung=rung0)
                                for f in range(i, i + fpc)]
                        flags = torch.stack([o[4] for o in outs])
                for f, out in zip(range(i, i + fpc), outs):
                    sums.add(f, out, with_rdf=False)

            if cfg.with_bad:
                self._rerun_flagged(cfg, a, sums)
            return self._finish(a, sums, cfg.n_species, a_blk)

        return chunked_step

    def _rerun_flagged(self, cfg: _Config, a: StepArgs, sums: _Sums):
        """Flagged frames added nothing to the BAD sums, so rerunning them
        at doubled capacity and adding their histograms is exact; their
        CN rows are replaced. The slab is dropped (a slab miss is a
        property of the data); a frame whose 1-level window missed moves
        to the full table."""
        flagged = torch.nonzero(sums.flag).flatten().tolist()
        rung = {f: "window" if cfg.bad_window is not None else "full"
                for f in flagged}
        k_re = self.max_neighbors
        while flagged and k_re < MAX_RERUN_CAPACITY:
            k_re *= 2
            still = []
            for f in flagged:
                out = _frame_pass(cfg, a, f, k_re, with_rdf=False,
                                  rung=rung[f])
                if bool(out[4]):
                    still.append(f)  # self-masked again
                    if rung[f] == "window" and bool(out[5]):
                        rung[f] = "full"
                    continue
                sums.cn[f] = out[1]
                sums.flag[f] = False
                sums.add_bad(out[2], out[3], out[4])
            flagged = still

    def run(self, batch, device="cuda") -> Tuple[Dict[str, np.ndarray], dict]:
        """Run the step; returns (outputs as numpy arrays, meta)."""
        step_fn, args, meta = self.prepare(batch, device)
        out = step_fn(*args)
        if self.with_bad and out["bad_overflow"].any():
            logger.warning(
                "BAD neighbor table flag: some atom exceeded "
                "max_neighbors=%d within cutoff, OR the sorted window "
                "(%s) failed its coverage check; angles were dropped. "
                "Raise max_neighbors, or widen/disable bad_window.",
                self.max_neighbors, self.bad_window,
            )
        return out, meta
