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

The table plan, the frame pass and the rerun ladder are
``ops/frame_table.py``'s, shared with the BAD and CN entry points. A
frame whose neighbour table overflowed K (or whose window missed)
contributes nothing to the BAD histograms in its first pass; with
``frames_per_call`` it is rerun up the ladder, so no angle is ever
dropped silently.

On the card the step's first pass on the slab rung replays one CUDA
graph a frame (``_FrameGraph``): some 300 launches and no wait for the
card, where the eager pass paid ~4 ms of host dispatch a frame for
~0.8 ms of device work. The capture and replay machinery is
``ops/frame_table.py``'s ``FrameGraph``, which the BAD entry point's
first pass shares; the frame's body stays here (``_graph_body``). A
step function owns its graphs: one capture for each K its groups start
at, at its first call. Every other pass (escalated groups, the rerun
ladder, the other rungs, the CPU) runs eagerly.

Spans and counters (``amof_tpu_torch.tracing``): ``pipeline.prepare``
(``.layout``, ``.slab_plan``, ``.upload``), ``pipeline.step``,
``pipeline.frame`` (``.rdf``; the table and angles as ``bad.table``,
``bad.angles``), ``pipeline.capture``, ``pipeline.sums``,
``pipeline.flags_read``, ``pipeline.rerun``, ``pipeline.msd``,
``pipeline.download``; counters ``pipeline.frames``,
``pipeline.frames_general_cell`` (first-pass frames of pieces whose
cells are not all diagonal), ``pipeline.prepares_width_cut``
(``prepare`` calls whose ``half_cell`` cut fell below half the smallest
cell length), ``pipeline.frames_graphed``, ``pipeline.graph_captures``
and the rerun tallies ``RERUNS`` (also in ``meta``).
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.core import cellmath
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import frame_table, msd_kernel, pair_engine
from amof_tpu_torch.warmup import after_warmup, resolve_device, warmup

logger = logging.getLogger(__name__)

# rerun tallies of one step (meta["reruns"]; counters "pipeline.<key>"):
# whole-group K doublings, frame passes of the per-frame ladder, frames
# that reached its full-table rung
RERUNS = ("groups_escalated", "frames_rerun", "frames_full_table")


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
    table: frame_table.TablePlan
    bins: int
    dr: float
    bad_bins: int
    dtheta: float
    blocked: bool
    ortho: bool
    with_bad: bool


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
    s = cfg.table.n_species
    rdf = None
    if with_rdf:
        with tracing.span("pipeline.frame.rdf"):
            rdf = volume * pair_engine.frame_rdf_counts(
                pos, cell, species_idx, cfg.dr, s, cfg.bins,
                blocked=cfg.blocked, ortho=cfg.ortho, inv_cell=inv,
            )
    if not cfg.with_bad:
        cn = pair_engine.frame_cn_counts(
            pos, cell, species_idx, cutoff_matrix, s, cfg.table.chunk,
            inv_cell=inv,
        )
        return rdf, cn, None, None, torch.zeros(
            (), dtype=torch.bool, device=pos.device), None
    bad_c, bad_a, flag, cn, missed = frame_table.frame_pass(
        cfg.table, pos, cell, inv, species_idx, cutoff_matrix, k_cap, rung,
        cfg.dtheta, cfg.bad_bins, emit_cn=True,
    )
    return rdf, cn, bad_c, bad_a, flag, missed


def _count_frames(cfg: _Config, n_frames: int) -> None:
    """A step's first-pass frames; on cells that are not all diagonal
    (the general-cell path) also ``pipeline.frames_general_cell``."""
    tracing.count("pipeline.frames", n_frames)
    if not cfg.ortho:
        tracing.count("pipeline.frames_general_cell", n_frames)


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
        s, dev = cfg.table.n_species, device
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
        frame_table.add_unflagged(self.bad_c, self.bad_a, bad_c, bad_a, flag)

    def add(self, f, out):
        """Frame ``f``'s CN row, flag and BAD counts (its RDF is added
        apart)."""
        _, cn, bad_c, bad_a, flag, _ = out
        self.cn[f] = cn
        self.flag[f] = flag
        if bad_c is not None:
            self.add_bad(bad_c, bad_a, flag)


def _graph_body(cfg: _Config, k_cap: int, x: dict, group: "_Sums"):
    """The fused step's slab-rung frame from the static inputs ``x``:
    its weighted RDF into ``group.rdf``, its flag-masked BAD counts into
    the group's accumulators, its CN row and flag into the group's slot
    ``x["slot"]``."""
    rdf, cn, bad_c, bad_a, flag, _ = _frame_math(
        cfg, x["pos"], x["cell"], x["inv"], x["volume"], x["species"],
        x["cutoff"], k_cap, True, "slab")
    group.rdf += rdf.to(torch.float64)
    group.add_bad(bad_c, bad_a, flag)
    group.cn.index_copy_(0, x["slot"], cn[None])
    group.flag.index_copy_(0, x["slot"], flag[None])


class _FrameGraph:
    """The first pass of a group of slab-rung frames, one
    ``frame_table.FrameGraph`` replay a frame on the card (eager on the
    CPU): kernel #1 and its volume weight, the slab layout, kernel #3,
    CN off the table, the angle histograms, and the frame's adds
    (``_graph_body``).

    The static inputs are the frame's positions, cell, inverse cell,
    volume and slot in its group, and the step's species and cutoffs.
    The outputs are ``group``, a ``_Sums`` of one group: the frame's
    weighted RDF goes into ``rdf`` (the step's RDF sum, shared by the
    step's graphs, so frames add in the eager order), its flag-masked
    BAD counts into the group's float64 accumulators, its CN row and
    flag into the group's slot. One step function owns its graphs
    (``_make_chunked_step``)."""

    def __init__(self, cfg: _Config, n_pad: int, k_cap: int, fpc: int,
                 rdf: torch.Tensor):
        dev = rdf.device
        s, f32 = cfg.table.n_species, torch.float32
        self.fpc = fpc
        x = {
            "pos": torch.zeros((n_pad, 3), dtype=f32, device=dev),
            "cell": torch.zeros((3, 3), dtype=f32, device=dev),
            "inv": torch.zeros((3, 3), dtype=f32, device=dev),
            "volume": torch.zeros((), dtype=f32, device=dev),
            "species": torch.zeros(n_pad, dtype=torch.int32, device=dev),
            "cutoff": torch.zeros((s, s), dtype=f32, device=dev),
            "slot": torch.zeros(1, dtype=torch.int64, device=dev),
        }
        self.slots = torch.arange(fpc, device=dev)
        g = self.group = _Sums(cfg, fpc, dev)  # its own BAD, CN and flags
        g.rdf = rdf
        self.frames = frame_table.FrameGraph(
            functools.partial(_graph_body, cfg, k_cap, x, g), x,
            (g.rdf, g.bad_c, g.bad_a, g.cn, g.flag), "pipeline")

    def first_pass(self, a: StepArgs, i: int):
        """Frames i .. i + fpc - 1 into the group's slots and accumulators
        (zeroed first); returns the group's flags."""
        self.frames.load({"species": a.species_idx,
                          "cutoff": a.cutoff_matrix})
        self.group.bad_c.zero_()
        self.group.bad_a.zero_()
        self.frames.run(
            ({"pos": a.positions[i + j], "cell": a.cells[i + j],
              "inv": a.inv_cells[i + j], "volume": a.volumes[i + j],
              "slot": self.slots[j:j + 1]} for j in range(self.fpc)),
            span="pipeline.frame")
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

    ``frames_per_call`` groups frames: a group where more than half the
    frames overflow K is rerun whole at doubled K (remembered for the
    group); single flagged frames then go up ``frame_table``'s rerun
    ladder. Without ``frames_per_call`` the step is one group of every
    frame at ``max_neighbors`` with no reruns: flagged frames are
    reported in ``bad_overflow`` and left out of the BAD histograms.
    MSD runs in atom blocks of ``msd_atoms_per_call`` atoms (auto-sized
    when None).

    On the card the step replays the slab rung's first passes from CUDA
    graphs that the step function owns: captured at its first call,
    replayed by later ones; a step function runs one call at a time.
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
        dev = resolve_device(device)
        handle = warmup(device=dev)  # build + context overlap the layout
        with tracing.span("pipeline.prepare.layout"):
            batch = as_frame_batch(batch)
            species = np.asarray(batch.species)
            unique, z_to_idx = frame_table.species_table(species)

            cells = np.asarray(batch.cell, dtype=np.float32)
            rmax = self.rmax
            if not rmax:
                rmax = cellmath.half_cell(cells)
                lengths = np.linalg.norm(cells.astype(np.float64), axis=2)
                if rmax < float(lengths.min()) / 2:  # a sheared cell
                    tracing.count("pipeline.prepares_width_cut")
            bins = int(rmax // self.dr)

            # species-blocked layout upgrades RDF to kernel #1 (BAD/CN/MSD
            # take the re-layout unchanged)
            positions, species_idx, blocked = frame_table.atom_layout(
                batch.positions, z_to_idx[species], multiple=self.chunk,
                block=int(np.lcm(256, self.chunk)))

            cutoff_matrix = frame_table.cutoff_matrix(
                self.nb_set_and_cutoff, unique, z_to_idx)
            pairs, bad_names = frame_table.enumerate_specs(
                self.nb_set_and_cutoff, unique)
            bad_specs = frame_table.spec_indices(pairs, z_to_idx)
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

        table = frame_table.table_plan(
            cells, cutoff_matrix, positions, species_idx, self.chunk,
            self.with_bad, window=self.bad_window,
            slab_span="pipeline.prepare.slab_plan")

        # diagonal-cell certificate for the RDF kernels' fast path
        ortho = bool(np.all(cells == cells * np.eye(3, dtype=cells.dtype)))

        with tracing.span("pipeline.prepare.upload"):
            frames = frame_table.upload(positions, cells, species_idx,
                                        cutoff_matrix, dev)
            args = StepArgs(
                positions=frames.positions, cells=frames.cells,
                inv_cells=frames.inv_cells,
                volumes=torch.from_numpy(volumes).to(dev),
                species_idx=frames.species_idx,
                cutoff_matrix=frames.cutoff_matrix,
                masses=torch.from_numpy(masses).to(dev),
            )
        cfg = _Config(
            table=table, bins=bins, dr=float(self.dr), bad_bins=bad_bins,
            dtheta=float(self.dtheta), blocked=blocked, ortho=ortho,
            with_bad=self.with_bad,
        )
        meta = {
            "unique": unique, "bins": bins, "rmax": rmax,
            "bad_names": bad_names, "bad_specs": bad_specs, "device": dev,
            "blocked": blocked, "ortho": ortho, "bad_window": table.window,
            "bad_slab": table.slab, "n_atoms_padded": n_pad,
        }
        a_blk = _msd_atom_block(batch.num_frames, n_pad,
                                self.msd_atoms_per_call)
        step_fn = self._make_chunked_step(cfg, meta, a_blk)
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

    def _make_chunked_step(self, cfg: _Config, meta, a_blk: int):
        """Grouped step: ``frames_per_call`` frames per group, whole-group
        K doubling when more than half a group flags, then per-frame
        reruns of the flagged frames (RDF skipped: it never uses the
        neighbour table) up ``frame_table``'s ladder. Capacities found
        per group are remembered across calls (they are a property of
        the data). Without ``frames_per_call``: one group of every frame,
        no escalation and no reruns."""
        escalate = cfg.with_bad and self.frames_per_call is not None
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
                _count_frames(cfg, n_frames)
                target = (n_frames if self.frames_per_call is None
                          else max(self.frames_per_call, 1))
                fpc = next(d for d in range(min(target, n_frames), 0, -1)
                           if n_frames % d == 0)
                meta["frames_per_call"] = fpc
                reruns = meta["reruns"] = dict.fromkeys(RERUNS, 0)
                dev = a.positions.device
                sums = _Sums(cfg, n_frames, dev)
                rung0 = cfg.table.first_rung()
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
                    if escalate:
                        if outs is not None:
                            flags = torch.stack([o[4] for o in outs])
                        # dense overflow: this data genuinely needs a
                        # bigger table -- escalate the whole group (BAD/CN
                        # only)
                        while (_count_flags(flags) > fpc // 2
                               and k_cap < frame_table.MAX_RERUN_CAPACITY):
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
                            sums.add(f, out)

                if escalate:
                    self._rerun_flagged(cfg, a, sums, reruns)
                if rung0 == "slab":
                    sums.rdf = sums.rdf.clone()  # the next call zeroes it
                return self._finish(a, sums, cfg.table.n_species, a_blk)

        return _one_call_at_a_time(chunked_step)

    def _rerun_flagged(self, cfg: _Config, a: StepArgs, sums: _Sums,
                       reruns: dict):
        """The flagged frames up ``frame_table``'s ladder from
        ``max_neighbors``: a frame that clears its flag adds its BAD
        counts and replaces its CN row. Tallies its passes in
        ``reruns``."""
        def run(f, k, rung):
            out = _frame_pass(cfg, a, f, k, with_rdf=False, rung=rung)
            return out[4], out[5], out

        def keep(f, out):
            with tracing.span("pipeline.sums"):
                sums.cn[f] = out[1]
                sums.flag[f] = False
                sums.add_bad(out[2], out[3], out[4])

        with tracing.span("pipeline.rerun"):
            flagged = torch.nonzero(sums.flag).flatten().tolist()
            frame_table.rerun_flagged(
                flagged, self.max_neighbors, cfg.table.window, run, keep,
                functools.partial(_tally, reruns))

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
