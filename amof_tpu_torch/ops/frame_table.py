"""
The K-slot neighbour table of a trajectory's frames, as the fused step
(``parallel/pipeline.py``) and the BAD and CN entry points run it: the
species, cutoff and spec tables, the atom layout (``atom_layout``: the
one 1.5x rule for the species-blocked layout), the table rule
(``table_plan``), one frame's pass on a rung (``frame_pass``), the
rerun ladder of flagged frames (``rerun_flagged``) and the frame graph
that replays a first pass on the card (``FrameGraph``).

The rung never changes a result: histograms and counts are exact and
independent of order, so a frame flagged on one rung (capacity overflow
or a window miss) reruns on the next and adds its counts there.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from amof_tpu_torch import tracing
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import bad_kernel, pair_engine, rdf_kernel, slab_table

# the ladder's K bound: its last round runs at this K
MAX_RERUN_CAPACITY = 1024
# the entry points' first-pass K (the fused step starts at max_neighbors)
FIRST_CAPACITY = 16


def species_table(species: np.ndarray):
    """Sorted unique atomic numbers + dense index mapping."""
    unique = np.array(sorted(set(np.asarray(species).tolist())))
    z_to_idx = np.full(int(unique.max()) + 1, -1, dtype=np.int32)
    z_to_idx[unique] = np.arange(len(unique), dtype=np.int32)
    return unique, z_to_idx


def cutoff_matrix(nb_set_and_cutoff, unique, z_to_idx):
    """[S, S] symmetric cutoff matrix over dense species indices."""
    mat = np.zeros((len(unique), len(unique)), dtype=np.float32)
    for nb_set, cutoff in nb_set_and_cutoff.items():
        ia, ib = (int(z_to_idx[elements.atomic_numbers[s]])
                  for s in nb_set.split("-"))
        mat[ia, ib] = mat[ib, ia] = cutoff
    return mat


def enumerate_specs(nb_set_and_cutoff, unique):
    """Wildcard-aware (center, outer) pair enumeration + column names.

    Mirrors amof/bad.py:122-133: "X" is appended iff the cutoff spec
    covers every species present; pairs with identical center and outer
    species are excluded except ("X", "X").
    """
    present = sorted({elements.atomic_numbers[s]
                      for nb_set in nb_set_and_cutoff
                      for s in nb_set.split("-")})
    epu = present + ["X"] if len(present) == len(unique) else present
    pairs = [(a, b) for b in epu for a in epu
             if a not in (b, "X") or (a, b) == ("X", "X")]

    def sym(z):
        return "X" if z == "X" else elements.symbol_of(z)

    return pairs, ["-".join([sym(b), sym(a), sym(b)]) for a, b in pairs]


def spec_indices(pairs, z_to_idx):
    """``enumerate_specs``' pairs as dense species indices (-1 = "X")."""
    return tuple(
        tuple(-1 if z == "X" else int(z_to_idx[z]) for z in pair)
        for pair in pairs
    )


def atom_layout(positions, species_idx, multiple: int = 256,
                block: Optional[int] = None):
    """(positions [F, N', 3] f32, species [N'] i32 with -1 pads, blocked).

    With ``block``, atoms are grouped by species and each group padded to
    a multiple of ``block`` (the total too), unless that would inflate the
    atom count past 1.5x; otherwise (and without ``block``) the atoms keep
    their order and the count is padded to a multiple of ``multiple``.
    Histograms are permutation-invariant, so every pass takes either."""
    positions = np.asarray(positions, np.float32)
    species_idx = np.asarray(species_idx, np.int32)
    if block is not None:
        perm, sp_l = rdf_kernel.species_block_layout(
            species_idx, block=block, total_multiple=block)
        if len(sp_l) <= 1.5 * len(species_idx):
            return (rdf_kernel.apply_atom_layout(positions, perm),
                    sp_l.astype(np.int32), True)
    positions, species_idx = pair_engine.pad_atoms(positions, species_idx,
                                                   multiple)
    return positions, species_idx, False


def sorted_window(cells, rc: float, n_pad: int):
    """The 1-level sorted window sized from the density and the largest
    cutoff (amof_tpu/cn.py:127-136, bad.py:105-115); ``table_plan`` drops
    it when it is not narrower than the frame."""
    c64 = np.asarray(cells, np.float64)
    bxc = np.cross(c64[:, 1], c64[:, 2])
    w0 = float((np.abs(np.einsum("fi,fi->f", c64[:, 0], bxc))
                / np.linalg.norm(bxc, axis=1)).min())
    est = 1.6 * n_pad * 2.0 * rc / max(w0, 1e-9) + 64
    return int(-(-est // 128) * 128)


class TablePlan(NamedTuple):
    """How every frame of a trajectory builds its K-slot table."""
    n_species: int
    chunk: int              # centers a step of the table pass
    window: Optional[int]   # the 1-level sorted window, or None
    slab: object            # slab_table.SlabPlan (2-level) or None

    def first_rung(self) -> str:
        if self.slab is not None:
            return "slab"
        return "window" if self.window is not None else "full"


def table_plan(cells, cutoff_matrix, positions, species_idx, chunk: int,
               with_bad: bool, window="auto", slab_span=None) -> TablePlan:
    """The table rule: the 1-level sorted window (kernel #4) whenever
    ``sorted_window`` gives one and the largest cutoff is above 0; the
    2-level slab table (kernel #3: ~3x fewer candidate tests than the
    window) on top whenever there is a window and BAD runs, on every
    device; the full O(N^2) table otherwise.

    ``window``: "auto" as above; None forces the full table; an int is
    used as-is (dropped when not narrower than the frame). The slab plan
    reads the padded host ``positions`` [F, N', 3] and ``species_idx``;
    it is built under the span ``slab_span``."""
    n_pad = positions.shape[1]
    rc = float(np.max(cutoff_matrix))
    if window == "auto":
        # pad rows carry uniformly-spread sort keys, so the window scales
        # with the PADDED atom count
        window = sorted_window(cells, rc, n_pad) if rc > 0 else None
    if window is not None and chunk + 2 * window >= n_pad:
        window = None
    slab = None
    if with_bad and window is not None:
        with tracing.span(slab_span) if slab_span else nullcontext():
            slab = slab_table.slab_plan(cells, rc, n_pad, positions=positions,
                                        species_idx=species_idx)
    return TablePlan(len(cutoff_matrix), chunk, window, slab)


class Frames(NamedTuple):
    """A trajectory on the device in its table layout."""
    positions: torch.Tensor      # f32 [F, N', 3]
    cells: torch.Tensor          # f32 [F, 3, 3]
    inv_cells: torch.Tensor      # f32 [F, 3, 3]
    species_idx: torch.Tensor    # i32 [N'] (-1 pads)
    cutoff_matrix: torch.Tensor  # f32 [S, S]


def upload(positions, cells, species_idx, cutoff_matrix, dev) -> Frames:
    """The host arrays on ``dev``; the inverse cells come from the CPU
    (``pair_engine.inverse_cell``)."""
    cells_t = torch.from_numpy(np.ascontiguousarray(cells, np.float32))
    return Frames(
        positions=torch.from_numpy(positions).to(dev),
        cells=cells_t.to(dev),
        inv_cells=pair_engine.inverse_cell(cells_t).to(dev),
        species_idx=torch.from_numpy(species_idx).to(dev),
        cutoff_matrix=torch.from_numpy(cutoff_matrix).to(dev),
    )


def entry_table(batch, nb_set_and_cutoff, dev, with_bad: bool):
    """The BAD and CN entry points' trajectory: atoms padded in input
    order, the chunk the largest divisor of the padded count up to 256,
    the table plan and the upload. Returns (unique, z_to_idx, plan,
    frames)."""
    species = np.asarray(batch.species)
    unique, z_to_idx = species_table(species)
    cut = cutoff_matrix(nb_set_and_cutoff, unique, z_to_idx)
    positions, species_idx, _ = atom_layout(batch.positions,
                                            z_to_idx[species])
    chunk = pair_engine._pick_chunk(positions.shape[1])
    cells = np.asarray(batch.cell, dtype=np.float32)
    plan = table_plan(cells, cut, positions, species_idx, chunk, with_bad)
    return (unique, z_to_idx, plan,
            upload(positions, cells, species_idx, cut, dev))


def frame_pass(plan: TablePlan, pos, cell, inv, species_idx, cutoff_matrix,
               k_cap: int, rung: str, dtheta: float, bins: int,
               emit_cn: bool = False, by_cn: bool = False, out=None):
    """One frame's table on ``rung`` ("slab", "window" or "full") at K
    ``k_cap`` and its angle histograms: ``bad_kernel.frame_bad_counts``'
    outputs with the window's miss flag last."""
    return bad_kernel.frame_bad_counts(
        pos, cell, species_idx, cutoff_matrix, plan.n_species, dtheta, bins,
        k_cap, plan.chunk,
        window=plan.window if rung in ("slab", "window") else None,
        emit_cn=emit_cn, slab=plan.slab if rung == "slab" else None,
        inv_cell=inv, emit_missed=True, by_cn=by_cn, out=out,
    )


def add_unflagged(acc_c, acc_a, bad_c, bad_a, flag):
    """Adds a frame's BAD counts into float64 accumulators unless its
    flag is up: a flagged frame adds NOTHING (self-masked, no host
    sync)."""
    keep = (~flag).to(torch.float64)
    acc_c += bad_c.to(torch.float64) * keep
    acc_a += bad_a.to(torch.float64) * keep


def rerun_flagged(frames, k_first: int, window, run, keep, tally=None):
    """The rerun ladder of flagged frames; returns the frames still
    flagged after its last round.

    Flagged frames added nothing to the BAD sums, so rerunning them and
    adding their counts is exact. Each round doubles K, from ``k_first``
    up to ``MAX_RERUN_CAPACITY``, and reruns every frame still flagged:
    on the 1-level window (the slab is dropped: a slab miss is a
    property of the data), on the full table without a window and from
    the round after a frame's window missed. ``run(f, k, rung)`` runs
    frame ``f`` and returns (flag, missed, out); ``keep(f, out)`` takes
    a frame whose flag is down. ``tally(key, n)`` counts passes
    (``frames_rerun``) and frames moved to the full table
    (``frames_full_table``)."""
    tally = tally or (lambda key, n=1: None)
    first = "window" if window is not None else "full"
    rung = dict.fromkeys(frames, first)
    if first == "full":
        tally("frames_full_table", len(frames))
    k = k_first
    while frames and k < MAX_RERUN_CAPACITY:
        k *= 2
        still = []
        for f in frames:
            flag, missed, out = run(f, k, rung[f])
            tally("frames_rerun")
            if bool(flag):
                still.append(f)
                if rung[f] == "window" and bool(missed):
                    rung[f] = "full"
                    tally("frames_full_table")
                continue
            keep(f, out)
        frames = still
    return frames


@contextmanager
def _capturing(graph, pool):
    """``graph`` captures the current stream's work in the block, into
    ``pool`` (None: a pool of its own). No cycle collection meanwhile:
    one that freed another owner's graph would call CUDA, which capture
    forbids."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()


class CaptureMemory:
    """A side stream and a memory pool on ``device`` for frame graphs
    captured one after another, each released before the next is
    captured: a capture then reuses the blocks the one before it
    reserved (~0.4 GB on the 9792-atom glass), where a pool of its own
    would reserve them anew from the card, and a new side stream would
    cache its own. A one-op graph captured here holds the pool open (a pool
    is released with the last graph that holds it)."""

    def __init__(self, device):
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
            self._holder = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream):
                with _capturing(self._holder, None):
                    torch.zeros(1, device=device)
        self.pool = self._holder.pool()


# each thread's capture stream and memory pool a device, which every
# call's graph takes: state of the device's memory, as the caching
# allocator's own is
_memory = threading.local()


def capture_memory(device) -> CaptureMemory:
    """This thread's ``CaptureMemory`` on ``device``: the graphs die with
    their calls, their device memory stays for the next."""
    by_device = _memory.__dict__.setdefault("by_device", {})
    if device not in by_device:
        by_device[device] = CaptureMemory(device)
    return by_device[device]


class FrameGraph:
    """A frame's first pass as one replayable unit: on the card a
    ``torch.cuda.CUDAGraph`` of its owner's ``body``, one launch a frame
    in place of some 300 and no wait for the card; elsewhere, or where
    ``graphed`` is False, ``body`` runs eagerly.

    ``body()`` reads only ``inputs``, static tensors by name that
    ``load`` fills by device-to-device copies, and adds into
    ``outputs``; the owner holds what the body does (the fused step's
    frame with its RDF and CN, BAD's counts). The graph is captured at
    the first frame, on a side stream after one eager pass there (which
    makes that stream's own state, such as kernel #1's work queue, and
    runs #1's root check); the outputs are restored after the
    capture, so every frame counts once. Its owner owns it: nothing
    caches a graph. ``memory``: a ``CaptureMemory`` whose stream and
    pool the capture takes (None: a new side stream, and a pool of the
    graph's own, released with it).

    Under ``prefix``: span ``<prefix>.capture``, counters
    ``<prefix>.graph_captures`` and ``<prefix>.frames_graphed`` (0 for
    an eager frame); each replay counts the ``launch.<kernel>`` its
    graph holds."""

    def __init__(self, body, inputs: dict, outputs, prefix: str,
                 graphed: bool = True, memory=None):
        self.body, self.inputs, self.outputs = body, inputs, tuple(outputs)
        self.prefix, self.memory = prefix, memory
        self.device = self.outputs[0].device
        self.graphed = graphed and self.device.type == "cuda"
        self.graph = None
        self.launches = {}  # launch.<kernel> -> launches a replay

    def load(self, sources: dict):
        """Each named input from its source, on the device."""
        for name, src in sources.items():
            self.inputs[name].copy_(src)

    def _capture(self):
        """One eager pass on a side stream, then the capture there. The
        launches the capture recorded did not run: they leave the
        counters, and each replay counts them."""
        with tracing.span(self.prefix + ".capture"):
            saved = [t.clone() for t in self.outputs]
            main = torch.cuda.current_stream(self.device)
            side = (self.memory.stream if self.memory
                    else torch.cuda.Stream(self.device))
            side.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                self.body()
                before = tracing.snapshot()["counts"]
                with _capturing(graph,
                                self.memory.pool if self.memory else None):
                    self.body()
                after = tracing.snapshot()["counts"]
            main.wait_stream(side)
            for t, old in zip(self.outputs, saved):
                t.copy_(old)
            self.launches = {k: n - before.get(k, 0)
                             for k, n in after.items()
                             if k.startswith("launch.")
                             and n != before.get(k, 0)}
            for k, n in self.launches.items():
                tracing.count(k, -n)
            self.graph = graph
            tracing.count(self.prefix + ".graph_captures")

    def run(self, frames, span: Optional[str] = None):
        """One frame for each item of ``frames`` (input name -> the
        tensor to load), each under ``span``: its inputs loaded, then a
        replay (the graph captured at the first) or ``body``."""
        on_card = self.device.type == "cuda"
        # capture and replay use the current device's streams
        with torch.cuda.device(self.device) if on_card else nullcontext():
            for sources in frames:
                if self.graphed and self.graph is None:
                    self.load(sources)
                    self._capture()
                with tracing.span(span) if span else nullcontext():
                    self.load(sources)
                    if self.graph is not None:
                        self.graph.replay()
                    else:
                        self.body()
                    for k, n in self.launches.items():
                        tracing.count(k, n)
                    tracing.count(self.prefix + ".frames_graphed",
                                  int(self.graph is not None))
