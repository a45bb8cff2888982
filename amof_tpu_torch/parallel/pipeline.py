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

On the card the chunked step's first pass on the slab rung replays one
CUDA graph a frame (``_FrameGraph``): some 300 launches and no wait for
the card, where the eager pass paid ~4 ms of host dispatch a frame for
~0.8 ms of device work. A step function owns its graphs: one capture
for each K its groups start at, at its first call. Every other pass
(escalated groups, the rerun ladder, the other rungs, the monolithic
step, the CPU) runs eagerly.

Spans and counters (``amof_tpu_torch.tracing``): ``pipeline.prepare``
(``.layout``, ``.slab_plan``, ``.upload``), ``pipeline.step``,
``pipeline.frame`` (``.rdf``; the table and angles as ``bad.table``,
``bad.angles``), ``pipeline.capture``, ``pipeline.sums``,
``pipeline.flags_read``, ``pipeline.rerun``, ``pipeline.msd``,
``pipeline.download``; counters ``pipeline.frames``,
``pipeline.frames_graphed``, ``pipeline.graph_captures`` and the rerun
tallies ``RERUNS`` (also in ``meta``).
"""

from __future__ import annotations

import functools
import gc
import logging
import threading
from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.bad import _enumerate_specs
from amof_tpu_torch.cn import _cutoff_matrix_for_species, sorted_window
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import bad_kernel, msd_kernel, pair_engine, rdf_kernel
from amof_tpu_torch.rdf import _species_table
from amof_tpu_torch.warmup import after_warmup, warmup

logger = logging.getLogger(__name__)

MAX_RERUN_CAPACITY = 1024  # the retry ladder's K bound
# rerun tallies of one step (meta["reruns"]; counters "pipeline.<key>"):
# whole-group K doublings, frame passes of the per-frame ladder, frames
# that reached its full-table rung
RERUNS = ("groups_escalated", "frames_rerun", "frames_full_table")


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
    with tracing.span("pipeline.frame"):
        return _frame_math(cfg, a.positions[f], a.cells[f], a.inv_cells[f],
                           a.volumes[f], a.species_idx, a.cutoff_matrix,
                           k_cap, with_rdf, rung)


def _frame_math(cfg: _Config, pos, cell, inv, volume, species_idx,
                cutoff_matrix, k_cap: int, with_rdf: bool, rung: str):
    """``_frame_pass`` on one frame's tensors (no span of its own)."""
    s = cfg.n_species
    rdf = None
    if with_rdf:
        with tracing.span("pipeline.frame.rdf"):
            rdf = volume * pair_engine.frame_rdf_counts(
                pos, cell, species_idx, cfg.dr, s, cfg.bins,
                blocked=cfg.blocked, ortho=cfg.ortho, inv_cell=inv,
            )
    if not cfg.with_bad:
        cn = pair_engine.frame_cn_counts(
            pos, cell, species_idx, cutoff_matrix, s, cfg.chunk,
            inv_cell=inv,
        )
        return rdf, cn, None, None, torch.zeros(
            (), dtype=torch.bool, device=pos.device), None
    bad_c, bad_a, flag, cn, missed = bad_kernel.frame_bad_counts(
        pos, cell, species_idx, cutoff_matrix, s, cfg.dtheta,
        cfg.bad_bins, k_cap, cfg.chunk,
        window=cfg.bad_window if rung in ("slab", "window") else None,
        emit_cn=True, slab=cfg.bad_slab if rung == "slab" else None,
        inv_cell=inv, emit_missed=True,
    )
    return rdf, cn, bad_c, bad_a, flag, missed


def _count_flags(flags) -> int:
    """Flagged frames of a group: a read that waits for the device."""
    with tracing.span("pipeline.flags_read"):
        return int(flags.sum())


def _tally(reruns: dict, key: str, n: int = 1) -> None:
    """Adds ``n`` to a step's rerun tally and to its process counter."""
    reruns[key] += n
    tracing.count("pipeline." + key, n)


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


class _FrameGraph:
    """The first pass of a slab-rung frame as one replayable unit: on
    CUDA a ``torch.cuda.CUDAGraph`` of ``_body`` (kernel #1 and its
    volume weight, the slab layout, kernel #3, CN off the table, the
    angle histograms, and the frame's adds), one launch a frame in place
    of ~300 and no wait for the card; on the CPU ``_body`` runs eagerly.

    ``_body`` reads static inputs, filled by device-to-device copies
    before each frame: the frame's positions, cell, inverse cell, volume
    and slot in its group, and the step's species and cutoffs. Its
    outputs are ``group``, a ``_Sums`` of one group: the frame's weighted
    RDF goes into ``rdf`` (the step's RDF sum, shared by the step's
    graphs, so frames add in the eager order), its flag-masked BAD
    counts into the group's float64 accumulators, its CN row and flag
    into the group's slot. The graph is captured at the first frame, on
    a side stream of its own after one eager pass there (which makes
    kernel #1's work queue for that stream and runs its root check); the
    outputs are restored after that pass, so every frame counts once.
    One step function owns its graphs (``_make_chunked_step``)."""

    def __init__(self, cfg: _Config, n_pad: int, k_cap: int, fpc: int,
                 rdf: torch.Tensor):
        self.device = dev = rdf.device
        s, f32 = cfg.n_species, torch.float32
        self.cfg, self.k_cap, self.fpc = cfg, k_cap, fpc
        self.pos = torch.zeros((n_pad, 3), dtype=f32, device=dev)
        self.cell = torch.zeros((3, 3), dtype=f32, device=dev)
        self.inv = torch.zeros((3, 3), dtype=f32, device=dev)
        self.volume = torch.zeros((), dtype=f32, device=dev)
        self.species = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        self.cutoff = torch.zeros((s, s), dtype=f32, device=dev)
        self.slots = torch.arange(fpc, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.group = _Sums(cfg, fpc, dev)  # its own BAD, CN and flags
        self.group.rdf = rdf
        self.graph = None
        self.launches = {}  # launch.<kernel> -> launches a replay

    def _body(self):
        rdf, cn, bad_c, bad_a, flag, _ = _frame_math(
            self.cfg, self.pos, self.cell, self.inv, self.volume,
            self.species, self.cutoff, self.k_cap, True, "slab")
        g = self.group
        g.rdf += rdf.to(torch.float64)
        g.add_bad(bad_c, bad_a, flag)
        g.cn.index_copy_(0, self.slot, cn[None])
        g.flag.index_copy_(0, self.slot, flag[None])

    def _load(self, a: StepArgs, f: int, slot: int):
        self.pos.copy_(a.positions[f])
        self.cell.copy_(a.cells[f])
        self.inv.copy_(a.inv_cells[f])
        self.volume.copy_(a.volumes[f])
        self.slot.copy_(self.slots[slot:slot + 1])

    def _capture(self):
        """One eager pass on a side stream, then the capture there. The
        launches the capture recorded did not run: they leave the
        counters, and each replay counts them."""
        with tracing.span("pipeline.capture"):
            g = self.group
            outs = (g.rdf, g.bad_c, g.bad_a, g.cn, g.flag)
            saved = [t.clone() for t in outs]
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self._body()
                before = tracing.snapshot()["counts"]
                # no cycle collection while capturing: one that freed
                # another step's graph would call CUDA, which capture
                # forbids
                collecting = gc.isenabled()
                gc.disable()
                try:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self._body()
                    finally:
                        graph.capture_end()
                finally:
                    if collecting:
                        gc.enable()
                after = tracing.snapshot()["counts"]
            main.wait_stream(side)
            for t, old in zip(outs, saved):
                t.copy_(old)
            self.launches = {k: n - before.get(k, 0)
                             for k, n in after.items()
                             if k.startswith("launch.")
                             and n != before.get(k, 0)}
            for k, n in self.launches.items():
                tracing.count(k, -n)
            self.graph = graph
            tracing.count("pipeline.graph_captures")

    def first_pass(self, a: StepArgs, i: int):
        """Frames i .. i + fpc - 1 into the group's slots and accumulators
        (zeroed first); returns the group's flags."""
        self.species.copy_(a.species_idx)
        self.cutoff.copy_(a.cutoff_matrix)
        self.group.bad_c.zero_()
        self.group.bad_a.zero_()
        on_card = self.device.type == "cuda"
        # capture and replay use the current device's streams
        with torch.cuda.device(self.device) if on_card else nullcontext():
            for j in range(self.fpc):
                if on_card and self.graph is None:
                    self._load(a, i + j, j)
                    self._capture()
                with tracing.span("pipeline.frame"):
                    self._load(a, i + j, j)
                    if on_card:
                        self.graph.replay()
                    else:
                        self._body()
                    for k, n in self.launches.items():
                        tracing.count(k, n)
                    tracing.count("pipeline.frames_graphed", int(on_card))
        return self.group.flag

    def add_group(self, sums: "_Sums", i: int):
        """The group's first pass into the step's sums (RDF is there
        already)."""
        g = self.group
        sums.bad_c += g.bad_c
        sums.bad_a += g.bad_a
        sums.cn[i:i + self.fpc] = g.cn
        sums.flag[i:i + self.fpc] = g.flag


def _one_call_at_a_time(step):
    """``step``, refusing a call that starts while another runs: the
    step's frame graphs and sums serve its calls in turn."""
    running = threading.Lock()

    @functools.wraps(step)
    def guarded(*args):
        if not running.acquire(blocking=False):
            raise RuntimeError(
                "this step function is running already; call prepare "
                "again for a step function of its own")
        try:
            return step(*args)
        finally:
            running.release()

    return guarded


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

    On the card the chunked step replays the slab rung's first passes
    from CUDA graphs that the step function owns: captured at its first
    call, replayed by later ones; a step function runs one call at a
    time.
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
        with tracing.span("pipeline.prepare"):
            return self._prepare(batch, device)

    def _prepare(self, batch, device):
        from amof_tpu_torch.ops import slab_table

        dev = resolve_device(device)
        handle = warmup(device=dev)  # build + context overlap the layout
        with tracing.span("pipeline.prepare.layout"):
            batch = as_frame_batch(batch)
            species = np.asarray(batch.species)
            unique, z_to_idx = _species_table(species)
            n_species = len(unique)

            cells = np.asarray(batch.cell, dtype=np.float32)
            lengths = np.linalg.norm(cells.astype(np.float64), axis=2)
            rmax = self.rmax or float(lengths.min()) / 2
            bins = int(rmax // self.dr)

            # species-blocked layout upgrades RDF to kernel #1 (histograms
            # are permutation-invariant, so BAD/CN/MSD take the re-layout
            # unchanged); skipped when per-species padding to 256-atom
            # tiles would inflate the atom count past 1.5x
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
            pairs, bad_names = _enumerate_specs(self.nb_set_and_cutoff,
                                                unique)
            bad_specs = tuple(
                (
                    -1 if sa == "X" else int(z_to_idx[sa]),
                    -1 if sb == "X" else int(z_to_idx[sb]),
                )
                for sa, sb in pairs
            )
            bad_bins = int(180 // self.dtheta) + 1
            # per-slot masses (pads may be interleaved by the blocked
            # layout)
            z_slot = np.asarray(unique)[np.maximum(species_idx, 0)]
            masses = np.where(
                species_idx >= 0, elements.mass_of(z_slot), 0.0
            ).astype(np.float32)
            volumes = np.abs(np.linalg.det(cells.astype(np.float64))).astype(
                np.float32)

            n_pad = positions.shape[1]
            bad_window = self.bad_window
            if bad_window == "auto":
                # pad rows carry uniformly-spread sort keys, so the window
                # scales with the PADDED atom count
                bad_window = sorted_window(cells, float(cutoff_matrix.max()),
                                           n_pad, self.chunk)
            if bad_window is not None and self.chunk + 2 * bad_window >= n_pad:
                bad_window = None

        # 2-level (slab, y) windows for the BAD/CN table: ~3x fewer
        # candidate tests than the 1-level x-window
        bad_slab = None
        if self.with_bad and bad_window is not None:
            with tracing.span("pipeline.prepare.slab_plan"):
                bad_slab = slab_table.slab_plan(
                    cells, float(cutoff_matrix.max()), n_pad,
                    positions=positions, species_idx=species_idx,
                )

        # diagonal-cell certificate for the RDF kernels' fast path
        ortho = bool(np.all(cells == cells * np.eye(3, dtype=cells.dtype)))

        with tracing.span("pipeline.prepare.upload"):
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
            step_fn = self._make_step(cfg, meta, n_pad)
        return after_warmup(handle, step_fn), args, meta

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
            with tracing.span("pipeline.msd"):
                out["msd"], out["msd_species"] = _msd(
                    a, n_species, self.origin_policy, a_blk)
        with tracing.span("pipeline.download"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    def _make_step(self, cfg: _Config, meta, n_pad: int):
        """Monolithic step: every frame once at ``max_neighbors``."""
        def step(*args):
            with tracing.span("pipeline.step"):
                a = StepArgs(*args)
                n_frames = a.positions.shape[0]
                tracing.count("pipeline.frames", n_frames)
                meta["reruns"] = dict.fromkeys(RERUNS, 0)
                sums = _Sums(cfg, n_frames, a.positions.device)
                rung = _first_rung(cfg)
                for f in range(n_frames):
                    out = _frame_pass(cfg, a, f, self.max_neighbors,
                                      rung=rung)
                    with tracing.span("pipeline.sums"):
                        sums.add(f, out)
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
        # the slab rung's frame graphs, (padded atoms, K, group size) ->
        # _FrameGraph, and the RDF sum they add into
        graphs = {}
        rdf_sum = None

        def chunked_step(*args):
            nonlocal rdf_sum
            with tracing.span("pipeline.step"):
                a = StepArgs(*args)
                n_frames = a.positions.shape[0]
                tracing.count("pipeline.frames", n_frames)
                target = max(self.frames_per_call, 1)
                fpc = next(d for d in range(min(target, n_frames), 0, -1)
                           if n_frames % d == 0)
                meta["frames_per_call"] = fpc
                reruns = meta["reruns"] = dict.fromkeys(RERUNS, 0)
                dev = a.positions.device
                sums = _Sums(cfg, n_frames, dev)
                rung0 = _first_rung(cfg)
                if rung0 == "slab":
                    if rdf_sum is None:
                        rdf_sum = torch.zeros_like(sums.rdf)
                    sums.rdf = rdf_sum.zero_()
                for i in range(0, n_frames, fpc):
                    k_cap = group_caps.get(i, self.max_neighbors)
                    if rung0 == "slab":
                        key = (a.positions.shape[1], k_cap, fpc)
                        graph = graphs.get(key)
                        if graph is None:
                            graph = graphs[key] = _FrameGraph(
                                cfg, *key, sums.rdf)
                        flags, outs = graph.first_pass(a, i), None
                    else:
                        outs = [_frame_pass(cfg, a, f, k_cap, rung=rung0)
                                for f in range(i, i + fpc)]
                        with tracing.span("pipeline.sums"):
                            for out in outs:
                                sums.rdf += out[0].to(torch.float64)
                    if cfg.with_bad:
                        if outs is not None:
                            flags = torch.stack([o[4] for o in outs])
                        # dense overflow: this data genuinely needs a
                        # bigger table -- escalate the whole group (BAD/CN
                        # only)
                        while (_count_flags(flags) > fpc // 2
                               and k_cap < MAX_RERUN_CAPACITY):
                            k_cap *= 2
                            group_caps[i] = k_cap
                            _tally(reruns, "groups_escalated")
                            outs = [_frame_pass(cfg, a, f, k_cap,
                                                with_rdf=False, rung=rung0)
                                    for f in range(i, i + fpc)]
                            flags = torch.stack([o[4] for o in outs])
                    with tracing.span("pipeline.sums"):
                        if outs is None:
                            graph.add_group(sums, i)
                        for f, out in zip(range(i, i + fpc), outs or ()):
                            sums.add(f, out, with_rdf=False)

                if cfg.with_bad:
                    self._rerun_flagged(cfg, a, sums, reruns)
                if rung0 == "slab":
                    sums.rdf = sums.rdf.clone()  # the next call zeroes it
                return self._finish(a, sums, cfg.n_species, a_blk)

        return _one_call_at_a_time(chunked_step)

    def _rerun_flagged(self, cfg: _Config, a: StepArgs, sums: _Sums,
                       reruns: dict):
        """Flagged frames added nothing to the BAD sums, so rerunning them
        at doubled capacity and adding their histograms is exact; their
        CN rows are replaced. The slab is dropped (a slab miss is a
        property of the data); a frame whose 1-level window missed moves
        to the full table. Tallies its passes in ``reruns``."""
        with tracing.span("pipeline.rerun"):
            flagged = torch.nonzero(sums.flag).flatten().tolist()
            first = "window" if cfg.bad_window is not None else "full"
            rung = dict.fromkeys(flagged, first)
            if first == "full":
                _tally(reruns, "frames_full_table", len(flagged))
            k_re = self.max_neighbors
            while flagged and k_re < MAX_RERUN_CAPACITY:
                k_re *= 2
                still = []
                for f in flagged:
                    out = _frame_pass(cfg, a, f, k_re, with_rdf=False,
                                      rung=rung[f])
                    _tally(reruns, "frames_rerun")
                    if bool(out[4]):
                        still.append(f)  # self-masked again
                        if rung[f] == "window" and bool(out[5]):
                            rung[f] = "full"
                            _tally(reruns, "frames_full_table")
                        continue
                    with tracing.span("pipeline.sums"):
                        sums.cn[f] = out[1]
                        sums.flag[f] = False
                        sums.add_bad(out[2], out[3], out[4])
                flagged = still

    def run(self, batch, device="cuda") -> Tuple[Dict[str, np.ndarray], dict]:
        """Run the step; returns (outputs as numpy arrays, meta).
        ``meta["reruns"]`` holds this call's rerun tallies (``RERUNS``)."""
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
