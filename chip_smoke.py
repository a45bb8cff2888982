#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (amof_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line(s) of standard output:

  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. kernel build: ``amof_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
  3. each hand-written kernel against its plain PyTorch version on the
     card, at the shapes of bench.py's fused step (10240-atom ZIF-glass
     trajectory, dr 0.01 A, K 8; kernel #4 at K 16, chunk 256, W 1408):
     integer outputs must be equal, and so must the neighbour positions.
     Kernel #1 also on a triclinic frame and an order that breaks its
     blocked contract, its root against sqrtf on every float32 in
     [2^-100, FLT_MAX], its device time under the profiler and host
     enqueue time on bench frame 0, and the registers (ptxas), resident
     blocks per SM and waves of kernels #1 and #2. Kernel #2 (any atom
     order) at four shapes (``rdf_unblocked_cases``): bench frame 0 in
     ``pad_atoms`` order, the RDF-integral CN's call on it (dr 0.0001),
     a triclinic frame and the 272-atom side-run cell, each with
     CUDA-event, profiler device and host enqueue times, its counts
     (pairs, pairs under the cut), geometry and recounted bound
     (``rdf_any_work``). Kernel #3 (the slab table) also on
     bench frame 0 at K 16 (the ``Bad`` entry points' call) and on a
     crowded frame at K 16 (one Zn with twenty added N neighbours, so
     cnt > K): each case with CUDA-event, profiler device and host
     enqueue times and the work its inputs need (``slab_work``: chunks,
     live centers, kept columns, tests, valid pairs), plus its launch
     geometry and its launch path piece by piece on the host clock; its
     bound counts only the (live center, in-range real column) tests, the
     all-columns bound printed beside it. Kernel #4 (the 1-level window
     table) likewise on bench frame 0 at K 16 (the reruns' call), on the
     windowed CN pass's own input for that frame at K 32, and on the
     crowded frame at K 16 (``window_work``: blocks, fillers-only blocks,
     kept columns a block, tests, pairs past the y/z prefilter), its
     bound counting the prefilter over the (live center, kept column)
     pairs that its exact fractional-x cut leaves and the exact test over
     the pairs the prefilter keeps, the all-columns bound beside it;
  4. the main path: ``FusedAnalysis.run`` at bench.py's configuration
     (256 frames, dtheta 0.05 deg, chunk 256, max_neighbors 8,
     frames_per_call 128, BAD and MSD on). Launch counters are zeroed
     just before it and read just after it; kernels #1, #3 and #4 must
     have launched there (#4 on the frames that overflow K and rerun on
     the 1-level window). Kernel #2 is not on that path (the bench layout
     is species-blocked): side runs, counted apart, take the same step on
     a 4-frame excerpt with one crowded Zn and on a 272-atom cell (too
     small for the species-blocked layout), where #2 must launch;
  5. correctness: outputs finite and shaped, and a 2-frame excerpt run on
     the card equals the same run on the CPU (plain versions): RDF and CN
     counts exact, BAD totals exact with angles at most one bin apart,
     MSD to rtol 1e-4 plus float32 cancellation (8 ulps of the mean
     squared position);
  6. times on the card (CUDA events) for each kernel and its plain
     version, fused frames/s, and the device busy share under
     ``torch.profiler``, beside the card's name and power limit;
  7. split: the main path once more, unsynced, read off the port's own
     spans and counters (``amof_tpu_torch.tracing``): calls, inclusive
     and self host ms a frame of each span (the table goes to
     chiprun_out/).

The batched pore step (``BatchedPore``, column path) joins each phase at
bench.py's pore configuration (resolution 0.25 A, MC volume with 50000
samples, 0.5 A connectivity grid, the first 32 frames of the same
trajectory): phase 3 checks kernel #5 (void masks and MC fits, on
bench frames 0-2 and on the void-slab frame below; its bound counts only
the candidate pairs within reach in 3-D, the all-rows bound printed beside
it),
#6 (surface blockers: bench frame 0 under its channel mask, as the pore
step calls it, and with every atom, and the void-slab frame under its
mask; each case timed, with the rows its z cut keeps; the first also
under the profiler, with a geometry line; its bound counts only the
(point, blocker) pairs within reach in 3-D, the all-rows bound printed
beside it) and #7 (flood fill: both calls of the chain on bench
frame 0 and on the void-slab frame, and a (16, 512, 512) grid, where the
JAX package would take kernel #8; each case timed, with a geometry line
per launch) against their plain versions; phase 4 runs the pore step on
its own with the counters zeroed (all three must
launch, no frame may stay missed, records finite), plus a side run on the
glass with z squeezed into 72% of the box (a void slab: ASA and AV > 0);
phase 5 compares card and CPU on a 2048-atom excerpt (masks, labels, fits
and per-atom validity equal, records to rel 1e-5); phase 6 times pore
ms/frame, prepare and the kernels; phase 7 splits the pore step by stage.

The per-frame Zeo++-style pore path (``pore.zeopp``) and
``BatchedPore``'s distance-field plans join phases 4, 5 and 7
(``per_frame_phase``, ``per_frame_cpu_parity``, ``per_frame_stages``):
each call runs with the launch counters zeroed just before it and read
just after it, kernel #7 must launch, and its wall time, #7 launches and
peak device memory are printed: ``analyze_frame(-sa -vol)`` at its
defaults (0.2 A, 276^3 voxels) on bench frames 0-1 and on the void-slab
frame, kernel #7 then held against its plain version on the channel
masks of bench frame 0 and of the void slab (open and periodic inits);
``network`` with -sa -vol -res -chan -psd -volpo on the void slab
at 0.2 A (the full O(V N) field; cut to 0.25 A past 120 s); -block,
-ray_atom and the extras (-oms -axs -strinfo -gridG) on a 2048-atom
excerpt at 0.5 A; ``BatchedPore`` with an explicit grid= (grid and mc),
window=None, the two-level field (bench frames 0-1 at 276^3, where it
engages) and winding="exact" on the void slab. Phase 5 holds the card
against the CPU on the excerpt (fields, classification, surface and
covering counts, chords equal; every option's result; the field plans'
records to rel 1e-5); phase 7 splits the -sa -vol and full-options calls
by stage (``OUT_DIR/chip_smoke_per_frame_stages.txt``).

Per-analysis entry points (``rdf``, ``cn``, ``bad``, ``msd`` and
``pore.core``, through their pandas-free column functions, which the
classes' ``from_trajectory`` wraps; the card has no pandas): phase 2 is
the runtime warmup in this cold process (``amof_tpu_torch.warmup()``,
kernel #9, which runs the nvcc build; phase 3 times #9 beside
``src.clone()``, its ``library_ms``, and ``dst.copy_(src)``, and each
piece of the wrappers' launch path on the host clock), then a cold-start
child that times build, load, context and first launch and checks that
``FusedAnalysis`` prepare launches the warmup (``python3 chip_smoke.py
--cold-start-pairs``
runs that child alone plus bench.py's ``FusedAnalysis`` prepare + first
result from cold processes with and without the warmup); phase
4 runs each entry point on the bench trajectory with the counters zeroed
before it and read after it (RDF on 256 frames: #1; the RDF-integral CN
on 4: #2; CN on 32; Bad on 256: #3; BadByCn on 32; Bad on the crowded
4-frame excerpt: #4; WindowMsd on 256; Pore on 32: #5, #6, #7), then
CN on 32 frames both ways (the full O(N^2) pass, ``pair_engine.
frame_cn_counts`` a frame, and ``cn.cn_columns``, which takes the
windowed pass through kernel #4; columns equal, its counters printed); phase 5
compares every entry point's columns on the card and on the CPU on a
2048-atom excerpt.

Trajectory I/O and ring statistics (``trajectory``, ``ring``; no
kernel of the nine is on this path, the BFS is ``torch.matmul``): phase
2 prints ``g++ --version`` and the g++ build of the ring engine
(``amof_tpu_torch/native/ringsearch.cpp``) beside nvcc's time; phase 4
(``io_phase``) writes the first 32 bench frames as a LAMMPS ``dump
custom`` and as a CP2K xyz + ``.cell`` pair (%.9g), reads them back with
``read_traj`` (format sniffed) and ``read_cp2k_traj`` (arrays equal the
in-memory float32 frames, ``rdf.rdf_columns`` equal with kernel #1
launching, read wall and MB/s printed), then (``ring_phase``) runs
``Ring.census`` with {"Fr-Zn": 3.8} and max_search_depth 32 on the 4x4x4
decorated diamond net (1536 nodes, 4 frames of 0.1 A jitter): RC(12)
1024 and PN(12) 1 on every frame, final depth 16, no supercell census,
and the census's own split a frame (the ``ring.*`` spans of
``amof_tpu_torch.tracing``: guard, bond graph, BFS and copy, BFS device
time by CUDA events, C++ census) with
the peak device memory; side runs: ``Ring.census`` of one 8x8x8 frame
(12288 nodes, RC(12) 8192, the same checks and split), the spanning-ring
frame (the supercell census engages) and ``example_reduced.xyz`` with
its stored cutoff; phase 5 (``ring_cpu_parity``) holds the device BFS
against scipy's ``shortest_path`` on net frame 0, the census on the card
against the CPU (arrays and every report key) on three frames, and
``zeopp.network`` on a .cif written by ``io.cif.write_cif`` against
``network`` on the frame read back from it.

The second-to-last line is a JSON object describing the kernels (with
each one's bound: the larger of the bytes it must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s, H100 SXM data sheet); the last
is ``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that line. Without a CUDA device the script fails; it never runs on the
CPU instead. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CUTOFFS = {"Zn-N": 2.0, "C-C": 1.75, "C-N": 1.73, "C-H": 1.3}
BENCH = dict(dr=0.01, dtheta=0.05, chunk=256, max_neighbors=8,
             frames_per_call=128)
OUT_DIR = "chiprun_out"  # long outputs of a run (git-ignored)

PORE = dict(resolution=0.25, vol_method="mc", conn_resolution=0.5)
PORE_FRAMES = 32
FLOOD_8_GRID = (16, 512, 512)  # no block-skip shape in the JAX package
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12

KERNELS = [
    # name, source, the Pallas call it replaces
    ("rdf_counts_blocked", "amof_tpu_torch/csrc/rdf_hist.cu",
     "amof_tpu/ops/pallas_rdf.py:500"),
    ("rdf_counts", "amof_tpu_torch/csrc/rdf_hist.cu",
     "amof_tpu/ops/pallas_rdf.py:224"),
    ("window_table_slab", "amof_tpu_torch/csrc/window_table.cu",
     "amof_tpu/ops/pallas_neighbors.py:336"),
    ("window_table", "amof_tpu_torch/csrc/window_table.cu",
     "amof_tpu/ops/pallas_neighbors.py:163"),
    ("void_masks_points", "amof_tpu_torch/csrc/void_masks.cu",
     "amof_tpu/pore/surface_kernel.py:607"),
    ("surface_valid_columns", "amof_tpu_torch/csrc/surface_columns.cu",
     "amof_tpu/pore/surface_kernel.py:333"),
    ("flood_fill", "amof_tpu_torch/csrc/flood_fill.cu",
     "amof_tpu/pore/grid_kernel.py:937"),
    ("warmup_copy", "amof_tpu_torch/csrc/warmup.cu",
     "amof_tpu/warmup.py:72"),
]


# kernels that bench.py's configuration launches; rdf_counts (#2) runs
# only where the species-blocked layout would pad past 1.5x
MAIN_PATH = ("rdf_counts_blocked", "window_table_slab", "window_table")
# kernels of the batched pore step (its own main path)
PORE_PATH = ("void_masks_points", "surface_valid_columns", "flood_fill")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(msg):
    print(f"chip_smoke: {msg}", flush=True)


def make_trajectory(n_frames, n_atoms, seed=0, density=0.062):
    """bench.py's fused-step workload: amorphous Zn(C3N2H3)2 (ZIF glass
    stoichiometry) at the ZIF-4 number density, frames = base positions +
    a thermal random walk. Same recipe and seed as bench.py."""
    import numpy as np

    from amof_tpu_torch import FrameBatch

    rng = np.random.default_rng(seed)
    counts = {30: n_atoms // 17, 7: 4 * (n_atoms // 17),
              6: 6 * (n_atoms // 17)}
    counts[1] = n_atoms - sum(counts.values())
    species = np.concatenate(
        [np.full(c, z, np.int64) for z, c in counts.items()])
    box = (n_atoms / density) ** (1 / 3)
    base = rng.uniform(0, box, (n_atoms, 3)).astype(np.float32)
    disp = rng.normal(0, 0.1, (n_frames, n_atoms, 3)).astype(np.float32)
    positions = (base[None] + np.cumsum(disp, axis=0)) % box
    cells = np.tile(np.eye(3, dtype=np.float32) * box, (n_frames, 1, 1))
    return FrameBatch(positions, cells, species.astype(np.int32),
                      np.arange(n_frames, dtype=np.int32)), box


def crowd_one_zn(batch, frame, box, seed=5, n_crowd=20):
    """Copy of ``batch`` whose ``frame`` has twenty N atoms within 1.7 A
    of the first Zn: that Zn then has more than 16 neighbours (the fused
    step reruns the frame at K 16 and 32; ``Bad`` climbs its ladder from
    the slab at K 16 through the 1-level window to the full table at
    K 32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = batch.positions.copy()
    n_zn = int((batch.species == 30).sum())
    off = rng.normal(0, 1, (n_crowd, 3))
    off *= (rng.uniform(1.0, 1.7, n_crowd)
            / np.linalg.norm(off, axis=1))[:, None]
    pos[frame, n_zn:n_zn + n_crowd] = (pos[frame, 0] + off) % box
    return batch._replace(positions=pos.astype(np.float32))


def cuda_ms(fn, reps, warmup=1):
    """Mean ms per call on the card (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def us2(v):
    """A device time for a line of output: None (not measured) or rounded
    to 0.01 us."""
    return v if v is None else round(v, 2)


def max_abs_err(got, ref):
    err = 0.0
    for g, r in zip(got, ref):
        err = max(err, float((g.double() - r.double()).abs().max()))
    return err


def kernel_checks(args, meta, batch, dev, card, frames=(0, 1, 2),
                  window_check=(16, 256, 1408)):
    """Phase 3: every kernel vs its plain version at the main path's
    shapes. Returns ({name: (max_abs_err, ms, plain_ms)}, {name: more
    keys of its kernel JSON}, {"rdf_counts": kernel #2's counts at shape
    (a), "window_table_slab": kernel #3's ``slab_work`` counts on bench
    frame 0 at K 8, "window_table": kernel #4's ``window_work`` counts on
    bench frame 0 at ``window_check``})."""
    import numpy as np
    import torch

    from amof_tpu_torch.ops import (neighbor_kernel, pair_engine,
                                    rdf_kernel, slab_table)
    from amof_tpu_torch.rdf import _species_table

    s = len(meta["unique"])
    bins = meta["bins"]
    dr = BENCH["dr"]
    cut = args.cutoff_matrix
    res = {}

    def compare(name, kern, plain):
        err = 0.0
        for f in frames:
            got, ref = kern(f), plain(f)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                check(g.shape == r.shape and g.dtype == r.dtype,
                      f"{name}: shape/dtype {g.shape} {g.dtype} vs "
                      f"{r.shape} {r.dtype}")
                check(torch.equal(g, r),
                      f"{name}: kernel != plain on frame {f} "
                      f"(max |diff| {max_abs_err([g], [r])})")
            err = max(err, max_abs_err(got, ref))
        ms = cuda_ms(lambda: kern(frames[0]), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: plain(frames[0]), reps=2, warmup=1)
        res[name] = (err, ms, plain_ms)
        say(f"kernel {name}: equal to plain on frames {list(frames)}; "
            f"{ms:.3f} ms/call vs plain {plain_ms:.3f} ms/call")

    pos, cells, inv, sp = (args.positions, args.cells, args.inv_cells,
                           args.species_idx)
    ortho = meta["ortho"]
    check(meta["blocked"], "bench layout should be species-blocked")
    compare(
        "rdf_counts_blocked",
        lambda f: rdf_kernel.rdf_counts_blocked(
            pos[f], cells[f], sp, dr, s, bins, ortho=ortho, inv_cell=inv[f]),
        lambda f: rdf_kernel.rdf_counts_plain(
            pos[f], cells[f], sp, dr, s, bins, ortho=ortho, inv_cell=inv[f]),
    )

    f0 = frames[0]

    def blocked0():
        return rdf_kernel.rdf_counts_blocked(
            pos[f0], cells[f0], sp, dr, s, bins, ortho=ortho, inv_cell=inv[f0])

    kern, every = (device_us(blocked0, k, reps=10)
                   for k in ("rdf_blocked_kernel", None))
    host = host_enqueue_us(blocked0)
    blocked_extras = {"device_us": kern, "device_all_us": every,
                      "host_us": host}
    say(f"kernel rdf_counts_blocked on bench frame 0: device {us2(kern)} "
        f"us/call in its kernel, {us2(every)} us/call in all device work "
        f"(torch.profiler, 10 calls), host enqueue {host:.2f} us/call on "
        f"{card}")
    rdf_blocked_side_checks(pos[f0], cells[f0], sp, s, bins)

    # kernel #2 on the bench trajectory in its own (unblocked) order
    unique, z_to_idx = _species_table(batch.species)
    pos_u, sp_u = pair_engine.pad_atoms(
        np.asarray(batch.positions[:max(frames) + 1]),
        z_to_idx[batch.species].astype(np.int32), BENCH["chunk"])
    pos_u = torch.from_numpy(pos_u).to(dev)
    sp_u = torch.from_numpy(sp_u).to(dev)
    compare(
        "rdf_counts",
        lambda f: rdf_kernel.rdf_counts(
            pos_u[f], cells[f], sp_u, dr, s, bins, ortho=ortho,
            inv_cell=inv[f]),
        lambda f: rdf_kernel.rdf_counts_plain(
            pos_u[f], cells[f], sp_u, dr, s, bins, ortho=ortho,
            inv_cell=inv[f]),
    )
    rdf_extras, rdf_counts = rdf_unblocked_cases(
        pos_u[frames[0]], sp_u, cells[frames[0]], inv[frames[0]], s, bins,
        ortho, dev, card)

    plan = meta["bad_slab"]
    check(plan is not None, "bench shapes should get a slab plan")
    layouts = {f: slab_table.build_slab_layout(pos[f], sp, cells[f], plan,
                                               inv_cell=inv[f])
               for f in frames}
    k = BENCH["max_neighbors"]
    compare(
        "window_table_slab",
        lambda f: neighbor_kernel.window_table_slab(
            *layouts[f][:4], cells[f], cut, k, plan.chunk, plan.window,
            inv_cell=inv[f]),
        lambda f: neighbor_kernel.window_table_slab_plain(
            *layouts[f][:4], cells[f], cut, k, plan.chunk, plan.window,
            inv_cell=inv[f]),
    )
    say(f"slab plan: {plan._asdict()}")
    slab_extras, slab_counts = slab_kernel_cases(
        (layouts[frames[0]][:4], cells[frames[0]], cut, inv[frames[0]], plan),
        batch, dev, card)

    srt = {}
    for f in frames:
        _, pos_s, sp_s = pair_engine.sort_by_fractional_x(pos[f], sp, inv[f])
        srt[f] = (pos_s.contiguous(), sp_s.contiguous())
    compare(
        "window_table",
        lambda f: neighbor_kernel.window_table(
            *srt[f], cells[f], cut, *window_check, inv_cell=inv[f]),
        lambda f: neighbor_kernel.window_table_plain(
            *srt[f], cells[f], cut, *window_check, inv_cell=inv[f]),
    )
    window_extras, window_counts = window_kernel_cases(
        (srt[frames[0]], cells[frames[0]], cut, inv[frames[0]]),
        window_check, batch, dev, card)
    return (res, {"rdf_counts_blocked": blocked_extras,
                  "rdf_counts": rdf_extras, "window_table_slab": slab_extras,
                  "window_table": window_extras},
            {"rdf_counts": rdf_counts, "window_table_slab": slab_counts,
             "window_table": window_counts})


def window_work(srt, cell, cut, inv, k, chunk, w, cnt):
    """What kernel #4's inputs need (``window_kept_columns``, the kernel's
    cut, and ``window_prefilter``, its y/z pair prefilter): blocks, blocks
    of fillers only, live centers, kept (real, in-reach) columns a block
    with a live center, (live center, kept column) tests, those of them
    that pass the prefilter and are not the center's own column
    (``near``), valid pairs and rows with cnt > K."""
    import torch

    from amof_tpu_torch.ops import neighbor_kernel

    pos, sp = srt
    n = pos.shape[0]
    kept, live, first, rows, c0 = neighbor_kernel.window_kept_columns(
        pos, sp, cell, cut, k, chunk, w, inv_cell=inv)
    per = kept.sum(dim=1)
    busy = live > 0
    reach = neighbor_kernel.window_reach(cell, cut)
    near = torch.zeros((), dtype=torch.int64, device=pos.device)
    for b in torch.nonzero(busy)[:, 0].tolist():
        r0, nr, cb = int(first[b]), int(rows[b]), int(c0[b])
        on = sp[r0:r0 + nr] >= 0
        cols = torch.nonzero(kept[b])[:, 0]
        pf = neighbor_kernel.window_prefilter(
            pos[r0:r0 + nr][on], pos[(cb - w + cols) % n], inv, reach)
        own = w + r0 - cb + torch.nonzero(on)[:, 0]
        near += (pf & (cols[None, :] != own[:, None])).sum()
    return {"blocks": live.numel(), "empty_blocks": int((~busy).sum()),
            "live_centers": int(live.sum()),
            "kept_mean": float(per[busy].double().mean()),
            "kept_max": int(per.max()), "width": chunk + 2 * w,
            "tests": int((live * per).sum()), "near": int(near),
            "valid_pairs": int(cnt.long().sum()),
            "rows_over_k": int((cnt > k).sum())}


def window_kernel_cases(frame0, window_check, batch, dev, card):
    """Kernel #4 on three cases: bench frame 0 at the fused reruns' K 16,
    chunk 256, W 1408; the windowed CN pass's own input for the same
    frame (``cn``'s padded atoms, species order and cutoffs, sorted by
    fractional x as ``frame_cn_counts_windowed`` sorts them; K 32, its
    chunk and window); and the crowded frame (one Zn with twenty added N
    neighbours) at K 16. Each is held equal to the plain version and
    timed: CUDA events (10 calls), device time under the profiler (10
    calls) and host enqueue time; a counts line and the launch geometry.
    Returns (kernel JSON keys, the counts on the reruns' case)."""
    import numpy as np
    import torch

    from amof_tpu_torch import cn
    from amof_tpu_torch.ops import neighbor_kernel as nk
    from amof_tpu_torch.ops import pair_engine
    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    srt0, cell0, cut, inv0 = frame0
    kk, chunk, w = window_check
    species = np.asarray(batch.species)
    unique, z_to_idx = cn._species_table(species)
    cn_cut = torch.from_numpy(cn._cutoff_matrix_for_species(
        CUTOFFS, unique, z_to_idx)).to(dev)
    positions, species_idx = pair_engine.pad_atoms(
        np.asarray(batch.positions[:1], dtype=np.float32),
        z_to_idx[species].astype(np.int32))
    n_cn = positions.shape[1]
    cn_chunk = pair_engine._pick_chunk(n_cn)
    cells = np.asarray(batch.cell[:1], dtype=np.float32)
    cn_w = cn.sorted_window(cells, float(cn_cut.max()), n_cn, cn_chunk)
    cn_cell = torch.from_numpy(np.ascontiguousarray(cells[0])).to(dev)
    cn_inv = pair_engine.inverse_cell(cn_cell)
    _, cn_pos, cn_sp = pair_engine.sort_by_fractional_x(
        torch.from_numpy(positions[0]).to(dev),
        torch.from_numpy(species_idx).to(dev), cn_inv)
    box = float(batch.cell[0, 0, 0])
    crowded = crowd_one_zn(excerpt(batch, 1), 0, box)
    _, cargs, _ = FusedAnalysis(CUTOFFS, **BENCH).prepare(crowded, device=dev)
    _, cpos, csp = pair_engine.sort_by_fractional_x(
        cargs.positions[0], cargs.species_idx, cargs.inv_cells[0])
    cases = {
        f"bench frame 0, K {kk}": (srt0, cell0, cut, inv0, kk, chunk, w),
        f"CN pass frame 0, K {pair_engine.CN_WINDOW_SLOTS}": (
            (cn_pos, cn_sp), cn_cell, cn_cut, cn_inv,
            pair_engine.CN_WINDOW_SLOTS, cn_chunk, cn_w),
        f"crowded frame, K {kk}": ((cpos.contiguous(), csp.contiguous()),
                                   cargs.cells[0], cut, cargs.inv_cells[0],
                                   kk, chunk, w),
    }
    ms, dev_us, host_us, counts, geo = {}, {}, {}, {}, {}
    for what, (srt, cell, cm, inv, k, ch, win) in cases.items():
        ref, ms[what], dev_us[what], host_us[what] = equal_and_timed(
            "window_table", "window_table_kernel", what,
            lambda srt=srt, cell=cell, cm=cm, inv=inv, k=k, ch=ch, win=win:
            nk.window_table(*srt, cell, cm, k, ch, win, inv_cell=inv),
            lambda: nk.window_table_plain(*srt, cell, cm, k, ch, win,
                                          inv_cell=inv),
            card)
        counts[what] = cnt = window_work(srt, cell, cm, inv, k, ch, win,
                                         ref[2])
        if what.startswith("crowded"):
            check(cnt["rows_over_k"] > 0, "the crowded frame has no cnt > K")
        say(f"window table, {what} (chunk {ch}, W {win}): {cnt['blocks']} "
            f"blocks, {cnt['empty_blocks']} of fillers only, "
            f"{cnt['live_centers']} live centers; kept columns a block "
            f"{cnt['kept_mean']:.1f} (max {cnt['kept_max']}) of "
            f"{cnt['width']}; {cnt['tests']} (live center, kept column) "
            f"tests, {cnt['near']} of them past the y/z prefilter; "
            f"{cnt['valid_pairs']} valid pairs, "
            f"{cnt['rows_over_k']} rows with cnt > K (equal to plain)")
        n = srt[0].shape[0]
        if (n, k, ch, win) not in geo:
            geo[n, k, ch, win] = g = nk.window_table_geometry(
                n, ch, k, win, cm.shape[0])
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            say(f"geometry window_table ({n} rows, K {k}, chunk {ch}, W "
                f"{win}): "
                f"{g['blocks']} blocks of {g['threads']} threads "
                f"({g['cpb']} centers a block, {g['cpw']} a warp, "
                f"{g['bpc']} blocks a chunk), {g['smem_bytes']} B dynamic + "
                f"{g['static_smem_bytes']} B static shared ({g['cap']} "
                f"staged columns, {g['pass_columns']} a pass), "
                f"{g['registers']} registers, {g['blocks_per_sm']} blocks/SM "
                f"on {sms} SMs: "
                f"{g['blocks'] / (g['blocks_per_sm'] * sms):.2f} waves")
    extras = {"cases_ms": ms, "device_us": dev_us, "host_us": host_us,
              "counts": counts,
              "geometry": {f"{n} rows, K {k}, chunk {c}, W {w_}": g
                           for (n, k, c, w_), g in geo.items()}}
    return extras, counts[f"bench frame 0, K {kk}"]


def slab_work(lay, plan, k, cnt):
    """What kernel #3's inputs need: chunks, chunks of fillers only, live
    centers, kept (in-range) columns a chunk, (live center, in-range real
    column) tests, valid pairs and rows with cnt > K; for its bytes, the
    distinct candidate columns whose key a chunk with a live center reads
    (``key_columns``) and those that some such chunk keeps
    (``kept_columns``)."""
    import torch

    from amof_tpu_torch.ops import neighbor_kernel

    centers, cand, starts, qb = lay
    kept, rows = neighbor_kernel.slab_kept_columns(cand, starts, qb,
                                                   plan.window)
    real = (kept & (cand[3][rows] >= 0)).sum(dim=1)
    per = kept.sum(dim=1).float()
    live = (centers[:, 3] >= 0).reshape(-1, plan.chunk).sum(dim=1)
    busy = live > 0
    return {"chunks": live.numel(), "empty_chunks": int((~busy).sum()),
            "live_centers": int(live.sum()),
            "kept_mean": float(per.mean()), "kept_max": int(per.max()),
            "tests": int((live * real).sum()),
            "valid_pairs": int(cnt.long().sum()),
            "rows_over_k": int((cnt > k).sum()),
            "key_columns": int(torch.unique(rows[busy]).numel()),
            "kept_columns": int(torch.unique(
                rows[busy][kept[busy]]).numel())}


def host_enqueue_us(fn, reps=10, rounds=5):
    """Host microseconds a call (perf_counter around ``reps`` calls, no
    synchronize inside), the median of ``rounds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return sorted(out)[rounds // 2]


def slab_launch_path_us(lay, cell, cut, inv, plan, k, reps=2000):
    """Host microseconds a call of each piece of kernel #3's launch path
    on ``lay`` at K ``k``: the one allocation, the three output views, the
    bare ctypes launch, the stream query, and the whole wrapper (whose
    remainder is its input checks and Python)."""
    import torch

    from amof_tpu_torch import _build
    from amof_tpu_torch.ops import neighbor_kernel as nk

    m, m2, s = lay[0].shape[0], lay[1].shape[1], cut.shape[0]
    dev = lay[0].device
    buf = torch.empty(m * (4 * k + 1), dtype=torch.int32, device=dev)
    vals = (*(t.data_ptr() for t in (*lay, cell, inv, cut)), buf.data_ptr(),
            m, m2, s, k, plan.chunk, plan.window)
    fn = _build.library().window_table_slab_launch
    stream = _build.stream_ptr(lay[0])
    return time_host_pieces({
        "torch.empty": lambda: torch.empty(m * (4 * k + 1),
                                           dtype=torch.int32, device=dev),
        "output views": lambda: nk._table_views(buf, m, k),
        "bare ctypes launch": lambda: fn(*vals, stream),
        "stream_ptr": lambda: _build.stream_ptr(lay[0]),
        "window_table_slab": lambda: nk.window_table_slab(
            *lay, cell, cut, k, plan.chunk, plan.window, inv_cell=inv),
    }, reps)


def equal_and_timed(name, kernel_key, what, call, plain, card):
    """Holds ``call()`` (kernel ``name``) equal to ``plain()`` on ``what``
    and times it: CUDA events (10 calls after 2), device time of the
    kernels whose name holds ``kernel_key`` under the profiler (10 calls)
    and host enqueue time; prints the times. Returns (plain outputs, ms,
    device us or None, host us)."""
    import torch

    got, ref = call(), plain()
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        check(g.shape == r.shape and g.dtype == r.dtype and torch.equal(g, r),
              f"{name}: kernel != plain on {what}")
    ms = cuda_ms(call, reps=10, warmup=2)
    dev = device_us(call, kernel_key, reps=10)
    host = host_enqueue_us(call)
    say(f"kernel {name} on {what}: {ms:.4f} ms/call (CUDA events, 10 calls),"
        f" device {dev if dev is None else round(dev, 2)} us/call "
        f"(torch.profiler), host enqueue {host:.2f} us/call on {card}")
    return ref, ms, dev, host


def slab_kernel_cases(frame0, batch, dev, card):
    """Kernel #3 on the three cases of the fused step and the entry points:
    bench frame 0 at K 8 (the fused step's call), at K 16 (``Bad`` and
    ``BadByCn``), and the crowded frame (one Zn with twenty added N
    neighbours, ``crowd_one_zn``) at K 16. Each is held equal to the plain
    version and timed: CUDA events (10 calls), device time under the
    profiler (10 calls) and host enqueue time; a counts line and the
    launch geometry. Returns (kernel JSON keys, the counts on the fused
    step's call)."""
    import torch

    from amof_tpu_torch.ops import neighbor_kernel as nk
    from amof_tpu_torch.ops import slab_table
    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    lay0, cell0, cut, inv0, plan = frame0
    box = float(batch.cell[0, 0, 0])
    crowded = crowd_one_zn(excerpt(batch, 1), 0, box)
    _, cargs, cmeta = FusedAnalysis(CUTOFFS, **BENCH).prepare(crowded,
                                                              device=dev)
    cplan = cmeta["bad_slab"]
    check(cplan is not None, "the crowded frame should get a slab plan")
    clay = slab_table.build_slab_layout(
        cargs.positions[0], cargs.species_idx, cargs.cells[0], cplan,
        inv_cell=cargs.inv_cells[0])
    cases = {
        "bench frame 0, K 8": (lay0, cell0, inv0, plan, 8),
        "bench frame 0, K 16": (lay0, cell0, inv0, plan, 16),
        "crowded frame, K 16": (clay[:4], cargs.cells[0], cargs.inv_cells[0],
                                cplan, 16),
    }
    ms, dev_us, host_us, counts, geo = {}, {}, {}, {}, {}
    n_species = cut.shape[0]
    for what, (lay, cell, inv, pl, k) in cases.items():
        ref, ms[what], dev_us[what], host_us[what] = equal_and_timed(
            "window_table_slab", "window_table_slab", what,
            lambda lay=lay, cell=cell, inv=inv, pl=pl, k=k:
            nk.window_table_slab(*lay, cell, cut, k, pl.chunk, pl.window,
                                 inv_cell=inv),
            lambda: nk.window_table_slab_plain(*lay, cell, cut, k, pl.chunk,
                                               pl.window, inv_cell=inv),
            card)
        counts[what] = cnt = slab_work(lay, pl, k, ref[2])
        if what.startswith("crowded"):
            check(cnt["rows_over_k"] > 0, "the crowded frame has no cnt > K")
        say(f"slab table, {what}: {cnt['chunks']} chunks, "
            f"{cnt['empty_chunks']} of fillers only, {cnt['live_centers']} "
            f"live centers; kept columns a chunk {cnt['kept_mean']:.1f} "
            f"(max {cnt['kept_max']}) of {3 * pl.window}; {cnt['tests']} "
            f"(live center, in-range real column) tests; "
            f"{cnt['valid_pairs']} valid pairs, {cnt['rows_over_k']} rows "
            f"with cnt > K (equal to plain)")
        if k not in geo:
            geo[k] = g = nk.window_table_slab_geometry(
                lay[0].shape[0], pl.chunk, k, pl.window, n_species)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            say(f"geometry window_table_slab (K {k}): {g['blocks']} blocks "
                f"of {g['threads']} threads ({g['cpb']} centers a block, "
                f"{g['cpw']} a warp), "
                f"{g['smem_bytes']} B dynamic + {g['static_smem_bytes']} B "
                f"static shared ({g['cap']} staged columns, "
                f"{g['pass_columns']} a pass), {g['registers']} registers, "
                f"{g['blocks_per_sm']} blocks/SM on {sms} SMs: "
                f"{g['blocks'] / (g['blocks_per_sm'] * sms):.2f} waves")
    path = slab_launch_path_us(lay0, cell0, cut, inv0, plan, 8)
    say("launch path window_table_slab (bench frame 0, K 8), host us/call: "
        + ", ".join(f"{name} {us:.3f}" for name, us in path.items())
        + f" on {card}")
    extras = {"cases_ms": ms, "device_us": dev_us, "host_us": host_us,
              "counts": counts, "launch_path_us": path,
              "geometry": {f"K {k}": g for k, g in geo.items()}}
    return extras, counts["bench frame 0, K 8"]


def rdf_blocked_side_checks(pos, cell, sp, s, bins):
    """Kernel #1's root against sqrtf on every float32 it can meet, then
    kernel #1 off its fast path, on bench frame 0's atoms: a triclinic
    frame (the same fractional coordinates in a sheared cell; general
    template) and an order that breaks the blocked contract (a random
    permutation of the slots; per-pair species path). Each must equal the
    plain version."""
    import numpy as np
    import torch

    from amof_tpu_torch.ops import rdf_kernel
    from amof_tpu_torch.ops.pair_engine import inverse_cell

    t0 = time.perf_counter()
    bad = rdf_kernel.root_mismatches()
    check(bad == 0, f"rdf_counts_blocked: its root differs from sqrtf on "
          f"{bad} float32 values")
    say(f"kernel rdf_counts_blocked: its root equals sqrtf on every float32 "
        f"in [2^-100, FLT_MAX] ({time.perf_counter() - t0:.2f} s)")
    dr = BENCH["dr"]
    box = float(cell[0, 0])
    tri = torch.tensor([[box, 0, 0], [box / 4, box, 0], [box / 8, -box / 5,
                                                         box]],
                       dtype=torch.float32, device=pos.device)
    pos_tri = ((pos @ inverse_cell(cell)) @ tri).contiguous()
    order = torch.from_numpy(np.random.default_rng(1).permutation(
        len(sp))).to(pos.device)
    for what, p, c, t, ortho in (
            ("triclinic frame", pos_tri, tri, sp, False),
            ("contract-breaking order", pos[order].contiguous(), cell,
             sp[order].contiguous(), True)):
        inv = inverse_cell(c)
        got = rdf_kernel.rdf_counts_blocked(p, c, t, dr, s, bins,
                                            ortho=ortho, inv_cell=inv)
        ref = rdf_kernel.rdf_counts_plain(p, c, t, dr, s, bins, ortho=ortho,
                                          inv_cell=inv)
        torch.cuda.synchronize()
        check(float(ref.sum()) > 0, f"rdf_counts_blocked {what}: empty")
        check(torch.equal(got, ref),
              f"rdf_counts_blocked: kernel != plain on the {what} (max "
              f"|diff| {max_abs_err([got], [ref])})")
        ms = cuda_ms(lambda: rdf_kernel.rdf_counts_blocked(
            p, c, t, dr, s, bins, ortho=ortho, inv_cell=inv), reps=5)
        say(f"kernel rdf_counts_blocked: equal to plain on the {what}; "
            f"{ms:.3f} ms/call")


# f32 operations of kernel #2 a pair: the minimum-image d2 (ortho: 3
# differences, 3 scalings, 3 wraps of add, floor and subtract, 3 scalings
# back, 3 squares and 2 sums; general: 9 products and 6 sums each way) and
# the cut's compare; a kept pair adds the root (max, rsqrt, 2 products and
# 2 FMAs), the bin (product, add and subtract of the magic floor), the key
# (lookup, add) and the count
RDF_D2_OPS = {True: 24, False: 48}
RDF_KEPT_OPS = 12
RDF2_KERNELS = ("rdf_any_kernel", "rdf_fold_kernel")


def rdf_any_work(cnt):
    """(bytes, f32 operations) of one kernel #2 call on a case's counts
    (``rdf_unblocked_cases``): every slot read once (x, y, z, species: 16
    B), the float32 [S, S, bins] result written once, the folded device
    histogram written and read once, each block's shared histogram sent
    out once (not in MODE_GLOBAL, where each kept pair is a 4-B device
    atomic instead); the d2 and the cut for every real pair, the rest for
    the pairs under the cut."""
    from amof_tpu_torch.ops import rdf_kernel

    s, bins = cnt["n_species"], cnt["bins"]
    fold = 4 * (s * (s + 1) // 2 * bins)
    merge = (4 * cnt["under"] if cnt["mode"] == rdf_kernel.MODE_GLOBAL
             else cnt["blocks"] * fold)
    return (16 * cnt["slots"] + 4 * s * s * bins + 2 * fold + merge,
            RDF_D2_OPS[cnt["ortho"]] * cnt["pairs"]
            + RDF_KEPT_OPS * cnt["under"])


def rdf_unblocked_cases(pos_u, sp_u, cell, inv, s, bins, ortho, dev, card):
    """Kernel #2 at the shapes of its callers: (a) bench frame 0 in
    ``pair_engine.pad_atoms`` order at dr 0.01 (the PERF.md row); (b) the
    RDF-integral CN's call on it (dr 0.0001, bins to the largest cutoff,
    the general template, as ``rdf.rdf_cn_columns`` calls it); (c) the
    same fractional coordinates in a triclinic cell; (d) the 272-atom cell
    of the side run, as ``FusedAnalysis`` (chunk 64) lays it out. Each is
    held equal to the plain version and timed: CUDA events (10 calls after
    2), device time under the profiler of #2's kernels a call and of all
    device work a call (10 calls), host enqueue time; a counts line
    (slots, real pairs, pairs under the cut), the launch geometry and the
    bound recounted from the case's inputs (``rdf_any_work``). Returns
    (kernel JSON keys, the counts of case (a))."""
    import torch

    from amof_tpu_torch.ops import rdf_kernel
    from amof_tpu_torch.ops.pair_engine import inverse_cell
    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    dr = BENCH["dr"]
    box = float(cell[0, 0])
    tri = torch.tensor([[box, 0, 0], [box / 4, box, 0],
                        [box / 8, -box / 5, box]], dtype=torch.float32,
                       device=dev)
    small, _ = make_trajectory(1, 272, seed=1)
    _, sargs, smeta = FusedAnalysis(
        CUTOFFS, **{**BENCH, "chunk": 64}).prepare(small, device=dev)
    check(not smeta["blocked"], "272-atom cell should not be blocked")
    cases = {
        "(a) bench frame 0": (pos_u, cell, inv, sp_u, dr, bins, ortho),
        "(b) RDF-integral CN call": (
            pos_u, cell, inv, sp_u, 0.0001,
            int(max(CUTOFFS.values()) // 0.0001), False),
        "(c) triclinic frame": (((pos_u @ inv) @ tri).contiguous(), tri,
                                inverse_cell(tri), sp_u, dr, bins, False),
        "(d) 272-atom cell": (sargs.positions[0], sargs.cells[0],
                              sargs.inv_cells[0], sargs.species_idx, dr,
                              smeta["bins"], smeta["ortho"]),
    }
    out = {k: {} for k in ("cases_ms", "device_us", "device_all_us",
                           "host_us", "counts", "geometry", "bounds")}
    for what, (p, c, iv, t, d, b, o) in cases.items():
        def call(p=p, c=c, iv=iv, t=t, d=d, b=b, o=o):
            return rdf_kernel.rdf_counts(p, c, t, d, s, b, ortho=o,
                                         inv_cell=iv)

        ref = rdf_kernel.rdf_counts_plain(p, c, t, d, s, b, ortho=o,
                                          inv_cell=iv)
        got = call()
        torch.cuda.synchronize()
        check(float(ref.sum()) > 0, f"rdf_counts {what}: empty")
        check(torch.equal(got, ref), f"rdf_counts: kernel != plain on {what}"
              f" (max |diff| {max_abs_err([got], [ref])})")
        ms = cuda_ms(call, reps=10, warmup=2)
        kern = [device_us(call, k, reps=10) for k in RDF2_KERNELS]
        kern = None if None in kern else sum(kern)
        every = device_us(call, None, reps=10)
        host = host_enqueue_us(call)
        mode = rdf_kernel.smem_mode(s, b)
        geo = rdf_kernel.launch_geometry(mode, p.shape[0], s, b, o)
        n_real = int((t >= 0).sum())
        cnt = {"slots": p.shape[0], "atoms": n_real,
               "pairs": n_real * (n_real - 1) // 2,
               "under": int(ref.sum()) // 2, "n_species": s, "bins": b,
               "dr": d, "ortho": bool(o), "mode": mode,
               "blocks": geo["blocks"]}
        bound_ms, bound_by = bound(*rdf_any_work(cnt))
        for key, val in (("cases_ms", ms), ("device_us", kern),
                         ("device_all_us", every), ("host_us", host),
                         ("counts", cnt), ("geometry", geo),
                         ("bounds", {"bound_ms": bound_ms,
                                     "bound_by": bound_by})):
            out[key][what] = val
        say(f"rdf unblocked, {what}: {cnt['slots']} slots, {n_real} atoms, "
            f"{cnt['pairs']} pairs, {cnt['under']} under the cut "
            f"({100 * cnt['under'] / cnt['pairs']:.2f}%), dr {d}, {b} bins, "
            f"ortho {bool(o)}, mode {mode} (equal to plain)")
        say(f"kernel rdf_counts on {what}: {ms:.4f} ms/call (CUDA events, 10 "
            f"calls), device {us2(kern)} us/call in #2's kernels, "
            f"{us2(every)} us/call in all device work (torch.profiler), host "
            f"enqueue {host:.2f} us/call on {card}")
        say(f"geometry rdf_counts ({what}): {geo['blocks']} blocks of "
            f"{geo['threads']} threads for {geo['items']} work items, "
            f"{geo['smem_bytes']} B dynamic shared, {geo['registers']} "
            f"registers, {geo['blocks_per_sm']} blocks/SM on {geo['sms']} "
            f"SMs: {geo['waves']:.2f} waves")
        say(f"bound rdf_counts ({what}): {bound_ms:.4f} ms ({bound_by}) vs "
            f"{ms:.4f} ms on {card}")
    return out, out["counts"]["(a) bench frame 0"]


def rdf_geometry(n, n_u, s, bins, ortho):
    """Registers (ptxas and the runtime), resident blocks per SM and waves
    of kernels #1 (``n`` slots, blocked layout) and #2 (``n_u`` slots) at
    the bench shapes."""
    from amof_tpu_torch import _build
    from amof_tpu_torch.ops import rdf_kernel

    log = _build.BUILD_DIR / "ptxas.log"
    if log.exists():
        text = log.read_text()
        start = text.find("== rdf_hist.cu")
        section = text[start:text.find("\n== ", start + 1)]
        entry = None
        for line in section.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry:
                used = line.split(":", 1)[1].strip()
                say(f"ptxas rdf_hist.cu {entry}: {used}")
                entry = None
    out = {}
    for name, mode, slots in (
            ("rdf_counts_blocked", rdf_kernel.MODE_BLOCKED, n),
            ("rdf_counts", rdf_kernel.smem_mode(s, bins), n_u)):
        geo = rdf_kernel.launch_geometry(mode, slots, s, bins, ortho)
        out[name] = geo
        say(f"geometry {name}: {geo['blocks']} blocks of {geo['threads']} "
            f"threads for {geo['items']} work items, {geo['smem_bytes']} B "
            f"dynamic shared, {geo['registers']} registers, "
            f"{geo['blocks_per_sm']} blocks/SM on {geo['sms']} SMs: "
            f"{geo['waves']:.2f} waves")
    return out


_launch_base = {"spans": {}, "counts": {}}


def reset_launches():
    """Zeroes the launch counts ``read_launches`` reports (a snapshot of
    the port's registry, ``amof_tpu_torch.tracing``)."""
    global _launch_base
    from amof_tpu_torch import tracing

    _launch_base = tracing.snapshot()


def read_counts():
    """The registry's counters that moved since ``reset_launches``."""
    from amof_tpu_torch import tracing

    return tracing.diff(tracing.snapshot(), _launch_base)["counts"]


def read_launches():
    """Launches of each hand-written kernel since ``reset_launches``
    (the registry's ``launch.<kernel>`` counters)."""
    got = read_counts()
    return {name: got.get("launch." + name, 0) for name, _, _ in KERNELS}


def span_seconds(name):
    """Seconds the registry holds under span ``name`` in this process, or
    None where it has none (a build that did not run, say)."""
    from amof_tpu_torch import tracing

    entry = tracing.snapshot()["spans"].get(name)
    return None if entry is None else entry[1]


def registry_split(fa, batch, dev):
    """Phase 7: one fused run, unsynced, split by the port's own spans and
    counters (``amof_tpu_torch.tracing``): calls, inclusive and self host
    ms a frame of each span, and the counters of the run."""
    import torch

    from amof_tpu_torch import tracing

    torch.cuda.synchronize()
    before = tracing.snapshot()
    t0 = time.perf_counter()
    out, meta = fa.run(batch, device=dev)  # its download waits for the card
    wall = time.perf_counter() - t0
    got = tracing.diff(tracing.snapshot(), before)
    check(not out["bad_overflow"].any(), "registry split: frames left flagged")
    n = batch.num_frames
    lines = [f"registry split, {n} frames, unsynced: wall {wall:.3f} s = "
             f"{1e3 * wall / n:.3f} ms/frame; reruns {meta['reruns']}"]
    lines += [f"  {name:<26s} {1e3 * secs / n:8.3f} ms/frame, self "
              f"{1e3 * own / n:8.3f}, calls {calls}"
              for name, (calls, secs, own) in sorted(
                  got["spans"].items(), key=lambda kv: -kv[1][1])]
    lines += [f"  count {name}: {k}" for name, k in got["counts"].items()]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_stages.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for line in lines:
        say(line)


def check_outputs(out, meta, n_frames):
    import numpy as np

    s = len(meta["unique"])
    shapes = {
        "rdf_counts": (s, s, meta["bins"]),
        "cn_counts": (n_frames, s, s),
        "bad_concrete": (s, s, 1, int(180 // BENCH["dtheta"]) + 1),
        "msd": (n_frames,),
        "msd_species": (n_frames, s),
    }
    for key, shape in shapes.items():
        check(out[key].shape == shape, f"{key} shape {out[key].shape}")
        check(np.isfinite(out[key]).all(), f"{key} not finite")
    check(out["rdf_counts"].sum() > 0, "empty RDF")
    check(out["bad_center_any"].sum() > 0, "empty BAD")
    check(not out["bad_overflow"].any(), "frames left flagged")


def bins_within_one(got, ref):
    """Equal totals per row; differences explained by one-bin moves."""
    import numpy as np

    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, ref.shape[-1])
    if not np.array_equal(got.sum(axis=1), ref.sum(axis=1)):
        return False
    flow = np.cumsum(got - ref, axis=1)[:, :-1]
    cap = np.maximum(got[:, :-1], ref[:, :-1]) + np.maximum(got[:, 1:],
                                                             ref[:, 1:])
    return bool(np.all(np.abs(flow) <= cap))


def cpu_parity(batch, n_frames=2):
    """Phase 5: a short excerpt on the card vs on the CPU (plain)."""
    import numpy as np

    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    sub = batch._replace(positions=batch.positions[:n_frames],
                         cell=batch.cell[:n_frames],
                         step=batch.step[:n_frames])
    kw = {k: v for k, v in BENCH.items() if k != "frames_per_call"}
    fa = FusedAnalysis(CUTOFFS, **kw)
    t0 = time.perf_counter()
    gpu, _ = fa.run(sub, device="cuda")
    cpu, _ = fa.run(sub, device="cpu")
    check(np.array_equal(gpu["rdf_counts"], cpu["rdf_counts"]),
          "RDF: card != CPU plain")
    check(np.array_equal(gpu["cn_counts"], cpu["cn_counts"]),
          "CN: card != CPU plain")
    for key in ("bad_concrete", "bad_center_any"):
        check(bins_within_one(gpu[key], cpu[key]),
              f"{key}: card vs CPU beyond one-bin moves")
    moved = float(np.abs(gpu["bad_center_any"] - cpu["bad_center_any"]).sum())
    # f32 FFT round-off: rtol 1e-4, plus 8 ulps of the mean squared
    # centered position (the size of the terms that cancel in the MSD)
    x = sub.positions.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    atol = 8 * 2.0**-23 * float((x ** 2).sum(axis=-1).mean())
    for key in ("msd", "msd_species"):
        check(np.allclose(gpu[key], cpu[key], rtol=1e-4, atol=atol),
              f"{key}: card vs CPU beyond rtol 1e-4 + {atol:.2e}")
    say(f"card == CPU plain on {n_frames} frames: RDF {gpu['rdf_counts'].sum():.6e} "
        f"CN {gpu['cn_counts'].sum():.0f} exact; BAD total "
        f"{gpu['bad_center_any'].sum():.0f} exact, {moved:.0f} angle-bin "
        f"differences; MSD rtol 1e-4 ({time.perf_counter() - t0:.1f} s)")


def profiled(run, n_frames, title, out_name):
    """Device time by kernel name over one ``run()`` (torch.profiler),
    after one warm-up call; the full table goes to OUT_DIR/out_name.
    Returns the device busy share, or None where the profiler saw no
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_name), "w") as fh:
        fh.write(table)
    # device-side events only (kernels, memcpy, memset): the aten rows
    # repeat their kernels' time as "self CUDA"
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not evs:
        say(f"{title}: the profiler reported no device events (busy share "
            "not measured)")
        return None
    busy = sum(e.self_device_time_total for e in evs) / 1e3  # ms
    share = busy / (wall * 1e3)
    say(f"{title} ({n_frames} frames): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * share:.0f}%), idle "
        f"{100 * (1 - share):.0f}%")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        say(f"  {e.self_device_time_total / 1e3 / n_frames:8.3f} ms/frame "
            f"{e.count / n_frames:6.1f}/frame  {e.key[:70]}")
    return share


def device_us(fn, name, reps):
    """Mean device time (us) of one launch of the kernels whose name holds
    ``name``, under torch.profiler over ``reps`` calls of ``fn`` after one
    warm-up: every caller's ``fn`` launches one such kernel, so this is
    the time a call. The mean is over the launches the trace holds (a
    trace can miss some); None where three traces hold none. ``name``
    None: every device event (kernels, memsets, copies) over ``reps``, the
    device time a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that holds no launch is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA
                and (name is None or name in e.key)]
        n = reps if name is None and seen else sum(e.count for e in seen)
        if n:
            return sum(e.self_device_time_total for e in seen) / n
    return None


def profile_step(batch, dev, n_frames=16):
    """Device time by kernel name over a short fused run (no MSD)."""
    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    sub = batch._replace(positions=batch.positions[:n_frames],
                         cell=batch.cell[:n_frames],
                         step=batch.step[:n_frames])
    kw = {k: v for k, v in BENCH.items() if k != "frames_per_call"}
    step_fn, args, _ = FusedAnalysis(CUTOFFS, with_msd=False, **kw).prepare(
        sub, device=dev)
    profiled(lambda: step_fn(*args), n_frames, "profile, no MSD",
             "chip_smoke_profile.txt")


# --------------------------------------------------------------------------
# The batched pore step (BatchedPore, column path)
# --------------------------------------------------------------------------

def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` and do ``n_ops`` f32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fused_work(args, meta, batch, counts, window_check=(16, 256, 1408)):
    """(bytes, f32 operations) of one call of kernels #1-#4 at the fused
    step's shapes: each input read once, each output written once; ~26
    operations per atom pair of #1's histogram (#2: ``rdf_any_work`` on
    the counts of its shape (a), ``counts["rdf_counts"]``), ~35 per
    candidate test of
    the neighbour tables, counted over the tests that the inputs need:
    for #3 the (live center, in-range real column) tests (``slab_work``
    counts ``counts["window_table_slab"]``); for #4 (``window_work``,
    ``counts["window_table"]``) ~13 for the y/z prefilter of each (live
    center, real column within the exact fractional-x reach) pair (two
    differences, two roundings, two subtractions, two absolute values, two
    sums, two compares and the self test) and ~35 for the exact test of
    each pair that passes it. #3 reads five rows of each input matrix:
    20 B a center (x, y, z, species, global index), 4 B of key for each
    column in a live chunk's runs and 20 B more for each column that some
    chunk keeps, the runs' starts and key ranges (36 B a chunk), the cell,
    its inverse and the cutoffs; it writes (16K + 4) B a center. #4 reads every sorted row once (x, y, z,
    species: 16 B), the cell, its inverse and the cutoffs, and writes
    (16K + 4) B a center."""
    n = batch.num_atoms
    n_pad = args.positions.shape[1]
    s = len(meta["unique"])
    hist = 4 * s * s * meta["bins"]
    pairs = n * (n - 1) // 2
    plan = meta["bad_slab"]
    k = BENCH["max_neighbors"]
    kk = window_check[0]
    slab, window = counts["window_table_slab"], counts["window_table"]
    return {
        "rdf_counts_blocked": (16 * n_pad + hist, 26 * pairs),
        "rdf_counts": rdf_any_work(counts["rdf_counts"]),
        "window_table_slab": (
            20 * plan.m_centers + 4 * slab["key_columns"]
            + 20 * slab["kept_columns"] + 36 * slab["chunks"] + 72
            + 4 * s * s + (16 * k + 4) * plan.m_centers,
            35 * slab["tests"]),
        "window_table": (16 * n_pad + 72 + 4 * s * s + (16 * kk + 4) * n_pad,
                         13 * window["tests"] + 35 * window["near"]),
    }


def pore_batch_of(batch, n_frames, squeeze=None):
    pos = batch.positions[:n_frames]
    if squeeze is not None:
        pos = pos.copy()
        pos[..., 2] *= squeeze
    return batch._replace(positions=pos, cell=batch.cell[:n_frames],
                          step=batch.step[:n_frames])


def pore_frame_inputs(pb, meta, dev, frame=0):
    """One frame's kernel inputs, as BatchedPore builds them: (frac, cell,
    inverse, radii, dirs, MC points tiled)."""
    import numpy as np
    import torch

    from amof_tpu_torch.data import elements
    from amof_tpu_torch.ops.pair_engine import matvec3
    from amof_tpu_torch.pore import grid_kernel
    from amof_tpu_torch.pore.zeopp import DEFAULT_NUM_SAMPLES

    cell = torch.from_numpy(np.ascontiguousarray(pb.cell[frame])).to(dev)
    inv = grid_kernel.host_inverse(cell)
    pos = torch.from_numpy(np.ascontiguousarray(pb.positions[frame])).to(dev)
    frac = matvec3(pos, inv)
    frac = (frac - torch.floor(frac)).contiguous()
    radii = elements.vdw_radius_array()[pb.species].astype(np.float32)
    dirs = grid_kernel.fibonacci_sphere(meta["k"])
    pts = np.random.default_rng(20240817).random(
        (DEFAULT_NUM_SAMPLES, 3)).astype(np.float32)
    pts_tiled, _ = grid_kernel.assign_points_to_xytiles(pts, meta["col_plan"])
    return (frac, cell, inv, torch.from_numpy(radii).to(dev),
            torch.from_numpy(dirs).to(dev), torch.from_numpy(pts_tiled).to(dev))


def void_masks_work(lay, cell, grid, cp, thr, pts, hi, fit, tile_batch=32):
    """(bytes, f32 operations, all-rows operations, pair counts) of one
    call of kernel #5 on these inputs, with ``hi`` the kernel's mask at
    thr_hi and ``fit`` its MC fits. Bytes: each input read once (payload,
    keys, column starts, cell, MC points) and each output written once.
    Operations: only for the pairs whose compare fails, the candidate rows
    within reach in 3-D (the plain version's f32 d2 below (R + thr)^2);
    every other pair passes its compare and changes no output. Per pair,
    counted from the kernel's expressions with the masks that ran: 9 per
    (voxel, candidate) with one mask (10 with two), 22 per
    (sub-column, candidate) that a voxel of the sub-column needs, 17 per
    (MC point, candidate). The all-rows count (every candidate of the tile
    for every voxel and point) is the bound of the earlier
    one-block-per-tile kernel. Checks that the voxels and points with a
    failing pair are exactly those the kernel closed."""
    import torch

    from amof_tpu_torch.ops.pair_engine import matvec3
    from amof_tpu_torch.pore import grid_kernel as gk

    gx, gy, gz = grid
    nbx, nby, window = cp["nbx"], cp["nby"], cp["window"]
    tvx, tvy = gx // nbx, gy // nby
    n_tiles, n_sub = nbx * nby, tvx * tvy
    thr_hi, thr_lo, thr_fit = thr
    vox_ops = 10 if thr_hi != thr_lo else 9
    c, dev = cell, cell.device
    azz = c[2, 0] * c[2, 0] + c[2, 1] * c[2, 1] + c[2, 2] * c[2, 2]
    sub = torch.arange(n_sub, device=dev)
    lx, ly = (sub // tvy).float(), (sub % tvy).float()
    vz = gk._div(torch.arange(gz, dtype=torch.float32, device=dev) + 0.5, gz)
    hi_t = hi.reshape(nbx, tvx, nby, tvy, gz).permute(0, 2, 1, 3, 4).reshape(
        n_tiles, n_sub, gz)
    vox_pairs = col_pairs = pt_pairs = 0
    for t0 in range(0, n_tiles, tile_batch):
        t = torch.arange(t0, min(t0 + tile_batch, n_tiles), device=dev)
        ti, tj, cx, cy = gk._tile_centers(t, nbx, nby)
        (fx, fy, fz, r), ok = gk._gather_runs(lay.payload, lay.start[t],
                                              lay.count[t], window)
        fxc = fx - torch.round(fx - cx[:, None])
        fyc = fy - torch.round(fy - cy[:, None])
        neg = torch.full_like(r, -1.0)
        sfx = gk._div((ti * tvx).float()[:, None] + lx + 0.5, gx)
        sfy = gk._div((tj * tvy).float()[:, None] + ly + 0.5, gy)
        dfx = sfx[:, :, None] - fxc[:, None, :]
        dfy = sfy[:, :, None] - fyc[:, None, :]
        qx = dfx * c[0, 0] + dfy * c[1, 0]
        qy = dfx * c[0, 1] + dfy * c[1, 1]
        qz = dfx * c[0, 2] + dfy * c[1, 2]
        qq = qx * qx + qy * qy + qz * qz
        qdz = (qx * c[2, 0] + qy * c[2, 1] + qz * c[2, 2]) * 2.0
        dz = vz[None, :, None] - fz[:, None, :]
        u = dz - torch.round(dz)
        uu = azz * (u * u)
        th = torch.where(ok, (r + thr_hi) * (r + thr_hi), neg)
        fails = ~(qq[:, :, None, :] + uu[:, None, :, :]
                  + u[:, None, :, :] * qdz[:, :, None, :]
                  >= th[:, None, None, :])  # [b, S, gz, 3W]
        vox_pairs += int(fails.sum())
        col_pairs += int(fails.any(dim=2).sum())
        check(torch.equal(fails.any(dim=3), ~hi_t[t]),
              "void_masks_work: the failing pairs do not give the mask")
        del fails
        v = matvec3(pts[t], c)
        wc = [fxc * c[0, i] + fyc * c[1, i] + fz * c[2, i] for i in range(3)]
        s = torch.round(pts[t][:, :, 2, None] - fz[:, None, :])
        d = [v[:, :, i, None] - wc[i][:, None, :] - s * c[2, i]
             for i in range(3)]
        th = torch.where(ok, (r + thr_fit) * (r + thr_fit), neg)
        fails = ~(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] >= th[:, None, :])
        pt_pairs += int(fails.sum())
        check(torch.equal(fails.any(dim=2), ~fit[t]),
              "void_masks_work: the failing pairs do not give the fits")
    n_cand = float(torch.clamp(lay.count, max=window).sum())
    n_pts = pts.shape[0] * pts.shape[1]
    n_vox = gx * gy * gz
    n_bytes = (20 * lay.payload.shape[1] + 8 * lay.cstarts.numel() + 36
               + 12 * n_pts + n_vox + n_pts)
    all_rows = n_cand * (22 * n_sub + vox_ops * n_sub * gz
                         + 17 * pts.shape[1])
    # what the kernel's cut keeps (its plain twin): rows per (tile, slab)
    kept = gk.void_masks_z_window(lay, cell, grid, cp["nbx"], cp["nby"],
                                  window, thr_hi).sum(dim=2).double()
    heights = torch.full((kept.shape[1],), float(gk.VOID_SLAB),
                         dtype=torch.float64, device=kept.device)
    heights[-1] = gz - gk.VOID_SLAB * (kept.shape[1] - 1)
    say(f"void_masks_points cut: {n_cand / n_tiles:.1f} candidate rows a "
        f"tile, {float(kept.mean()):.1f} kept a (tile, slab) block (max "
        f"{int(kept.max())}); (voxel, candidate) tests "
        f"{float((kept * heights).sum()) * n_sub:.4e} with the cut, "
        f"{n_cand * n_sub * gz:.4e} over all rows")
    return (n_bytes, vox_ops * vox_pairs + 22 * col_pairs + 17 * pt_pairs,
            all_rows, (vox_pairs, col_pairs, pt_pairs))


def surface_work(slay, cell, dirs, sp, n_z, r_probe=1.2, slot_batch=4):
    """(bytes, f32 operations, all-rows operations, counts) of one call of
    kernel #6 on a prepared layout. Bytes: each input read once (centers,
    blockers, column bounds, runs) and each output written once (9 B a
    point). Operations: 40 a point plus 16 a (point, blocker) pair that
    the kernel cannot skip, those within R_j + probe + mu of the point
    (float64, minimum image; mu the z cut's margin), the atom itself
    excepted; a kernel with a z cut and an early exit may test fewer rows
    than the all-rows count (every row of the column's three runs, the
    bound of the earlier one-block-per-slot kernel). ``counts``: active
    slots, groups, candidate and non-candidate centers of active slots,
    rows a group keeps after the z cut (mean, min, max; its plain twin),
    all rows a group, tests an item with and without the cut, pairs."""
    import numpy as np
    import torch

    from amof_tpu_torch.pore import grid_kernel as gk

    dev = cell.device
    chunk, window = sp["chunk"], sp["window"]
    n, m = slay.centers.shape[1], slay.blockers.shape[1]
    k = dirs.shape[0]
    cols, los, his = gk.active_slots(slay, n_z, chunk)
    ce = slay.cand_end.cpu().numpy().astype(np.int64)
    n_cand = int(np.sum(np.clip(np.minimum(his, ce[cols]) - los, 0, None)))
    n_rows = int(np.sum(his - los))
    b_rows = slay.b_count.sum(dim=1).cpu().numpy().astype(np.float64)
    (gcols, g0s, g1s), keep = gk.surface_z_window(
        slay, cell, dirs, r_probe, n_z, chunk, gk.surface_group_size(k),
        window)
    kept = keep.sum(dim=1).cpu().numpy().astype(np.float64)
    sizes = (g1s - g0s).astype(np.float64)
    _, mu = gk._z_cut_geometry(cell)
    c64, inv64 = cell.double(), torch.linalg.inv(cell.double())
    d64 = dirs.double()
    rp = float(np.float32(r_probe))
    pairs = 0
    for s0 in range(0, len(cols), slot_batch):
        col = torch.as_tensor(cols[s0:s0 + slot_batch], device=dev)
        lo = torch.as_tensor(los[s0:s0 + slot_batch], device=dev)
        hi = torch.as_tensor(his[s0:s0 + slot_batch], device=dev)
        rows = lo[:, None] + torch.arange(chunk, device=dev)
        live = rows < hi[:, None]
        rows = torch.clamp(rows, max=n - 1)
        fc = torch.stack([slay.centers[i][rows] for i in range(3)],
                         -1).double()
        ra = slay.centers[3][rows].double()
        cg = slay.centers[4][rows]
        p = (fc @ c64)[:, :, None, :] + (ra + rp)[:, :, None, None] * d64
        fp = p @ inv64
        (bx, by, bz, br, bg), ok = gk._gather_runs(
            slay.blockers, slay.b_start[col], slay.b_count[col], window)
        fb = torch.stack([bx, by, bz], -1).double()  # [a, 3W, 3]
        df = fp[:, :, :, None, :] - fb[:, None, None, :, :]
        df = df - torch.round(df)
        dist = torch.linalg.vector_norm(df @ c64, dim=-1)  # [a, CH, K, 3W]
        near = (dist < (br.double() + r_probe + mu)[:, None, None, :]) \
            & ok[:, None, None, :] & (bg[:, None, :] != cg[:, :, None])[
                :, :, None, :] & live[:, :, None, None]
        pairs += int(near.sum())
        del df, dist, near
    points = n_rows * k
    counts = {
        "slots": len(cols), "groups": len(gcols), "cand": n_cand,
        "non_cand": n_rows - n_cand, "kept_mean": float(kept.mean()),
        "kept_min": int(kept.min()), "kept_max": int(kept.max()),
        "rows_mean": float(b_rows[gcols].mean()),
        "tests_cut": float(np.sum(sizes * kept) / np.sum(sizes)),
        "tests_all": float(np.sum((his - los) * b_rows[cols]) / n_rows),
        "pairs": pairs}
    n_bytes = (20 * n + 20 * m + 8 * slay.c_bounds.numel()
               + 24 * slay.b_start.shape[0] + 9 * points)
    all_ops = float(np.sum((his - los) * k * (40 + 16 * b_rows[cols])))
    return n_bytes, 40 * points + 16 * pairs, all_ops, counts


def flood_occupied(mask):
    """How many of kernel #7's tiles hold a voxel of ``mask``."""
    import torch
    import torch.nn.functional as F

    from amof_tpu_torch.pore.grid_kernel import FLOOD_TILE as t

    pad = [(-s) % d for s, d in zip(mask.shape, t)]
    m = F.pad(mask.to(torch.uint8), (0, pad[2], 0, pad[1], 0, pad[0]))
    gx, gy, gz = m.shape
    return int(m.reshape(gx // t[0], t[0], gy // t[1], t[1], gz // t[2],
                         t[2]).amax((1, 3, 5)).sum())


def pore_kernel_checks(pb, slab_pb, meta, dev, card):
    """Phase 3, pore: kernel #5 against its plain version on bench frames
    0-2 and on frame 0 of the void slab, #7 on both calls of the chain on
    bench frame 0 and the void-slab frame and on a (16, 512, 512) grid
    (each case timed, with its launches' geometry), #6 on bench frame 0
    under its channel mask and with every atom and on the void-slab frame
    under its channel mask (each timed, with the rows its z cut keeps; the
    first also under the profiler, with its geometry), at the bench pore
    shapes. Returns ({name: (max_abs_err, ms,
    plain_ms)}, {name: (bytes, operations)}, {name: more keys of its
    kernel JSON}: all-rows bounds, times by case, geometry)."""
    import numpy as np
    import torch

    from amof_tpu_torch.pore import grid_kernel as gk
    from amof_tpu_torch.pore import surface_kernel as sk

    cp, sp = meta["col_plan"], meta["surf_plan"]
    grid = cp["grid"]
    n_vox = grid[0] * grid[1] * grid[2]
    res, work = {}, {}

    def equal(name, got, ref, what):
        got = [g for g in got if g is not None]
        ref = [r for r in ref if r is not None]
        check(len(got) == len(ref), f"{name}: output count")
        for g, r in zip(got, ref):
            check(g.shape == r.shape and g.dtype == r.dtype,
                  f"{name}: shape/dtype {g.shape} {g.dtype} vs "
                  f"{r.shape} {r.dtype} ({what})")
            check(torch.equal(g, r), f"{name}: kernel != plain ({what}; "
                  f"{int((g != r).sum())} items differ)")

    def timed(name, kern, plain, errs=0.0, reps=10):
        """Times one call of the kernel alone and of its plain version on
        the same prepared layout (the sorts that build it are glue,
        timed by the stage split)."""
        ms = cuda_ms(kern, reps=reps, warmup=2)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        res[name] = (errs, ms, plain_ms)
        say(f"kernel {name}: equal to plain; {ms:.3f} ms/call vs plain "
            f"{plain_ms:.3f} ms/call")

    cases = [(f"bench frame {f}", pore_frame_inputs(pb, meta, dev, f))
             for f in (0, 1, 2)]
    cases.append(("void-slab frame 0", pore_frame_inputs(slab_pb, meta, dev)))
    thr = gk.mask_thresholds(1.2, 1.2)
    chan = {}  # channel masks by frame, kernel #7's inputs
    for what, (frac, cell, inv, radii, dirs, pts) in reversed(cases):
        mk = (frac, cell, radii, grid, 1.2, 1.2, cp["nbx"], cp["nby"],
              cp["window"])
        got = sk.void_masks_points(*mk, pts_tiled=pts)
        ref = gk.void_masks_columns(*mk, pts_tiled=pts)
        torch.cuda.synchronize()
        equal("void_masks_points", got, ref, f"masks, MC fits, missed; {what}")
        check(not bool(got[3]), f"{what} missed the mask window")
        check(what.startswith("bench") or int(got[1].sum()) > 0,
              f"{what}: no voxel fits the probe")
        say(f"pore masks, {what}: {int(got[1].sum())} of {n_vox} voxels fit "
            f"the probe; fits {int(got[2].sum())} of {got[2].numel()} points"
            " (equal to plain)")
        chan[what] = got[1]
        lay = gk.masks_layout(frac, radii, cp["nbx"], cp["nby"], cp["window"])
        if what != "bench frame 0":
            slab_ms = cuda_ms(lambda: sk._launch_masks(
                lay, cell, grid, cp["nbx"], cp["nby"], cp["window"], *thr,
                pts), reps=10, warmup=2)
            say(f"kernel void_masks_points on {what}: {slab_ms:.3f} ms/call")
    m_chan = chan["bench frame 0"]  # whose inputs the rest of phase 3 uses
    timed("void_masks_points",
          lambda: sk._launch_masks(lay, cell, grid, cp["nbx"], cp["nby"],
                                   cp["window"], *thr, pts),
          lambda: gk.void_masks_tiles_plain(lay, cell, grid, cp["nbx"],
                                            cp["nby"], cp["window"], *thr,
                                            pts))
    # got[0], the probe mask, is the mask at thr_hi (probe >= channel)
    n_bytes, ops, all_ops, (vox_pairs, col_pairs, pt_pairs) = (
        void_masks_work(lay, cell, grid, cp, thr, pts, got[0], got[2]))
    work["void_masks_points"] = (n_bytes, ops)
    all_rows_ms = bound(n_bytes, all_ops)[0]
    say(f"void_masks_points work: {vox_pairs:.4e} (voxel, candidate), "
        f"{col_pairs:.4e} (sub-column, candidate) and {pt_pairs:.4e} "
        f"(point, candidate) pairs within 3-D reach, {ops:.4e} f32 ops; "
        f"every candidate row: {all_ops:.4e} ops, bound "
        f"{all_rows_ms:.4f} ms")

    # flood fill: both calls of the chain on bench frame 0 and on the
    # void-slab frame, then a grid of kernel #8's; each case timed
    flood = []  # (what, init, periodic)
    for what in ("bench frame 0", "void-slab frame 0"):
        mask = chan[what]
        open_init = torch.where(
            mask, torch.arange(n_vox, dtype=torch.int32,
                               device=dev).reshape(grid),
            torch.full(grid, -1, dtype=torch.int32, device=dev))
        lab = gk.propagate_fixpoint(open_init, False)
        equal("flood_fill", [lab],
              [gk.propagate_fixpoint_plain(open_init, False)],
              f"{what}, open boundaries, linear-index init")
        seeds = gk.winding_seeds(lab, mask)
        tern = torch.where(seeds, 1, torch.where(mask, 0, -1)).to(
            torch.int32)
        acc = gk.propagate_fixpoint(tern, True)
        equal("flood_fill", [acc], [gk.propagate_fixpoint_plain(tern, True)],
              f"{what}, periodic, {{1, 0, -1}} init")
        say(f"flood fill, {what}: {int(mask.sum())} of {n_vox} voxels in "
            f"{flood_occupied(mask)} of {gk.flood_tiles(grid)} tiles, "
            f"{int(seeds.sum())} winding seeds, {int((acc == 1).sum())} "
            f"accessible voxels (equal to plain)")
        flood += [(f"{what}, open, linear init", open_init, False),
                  (f"{what}, periodic, ternary init", tern, True)]
    rng = np.random.default_rng(8)
    m8 = torch.from_numpy(rng.random(FLOOD_8_GRID) < 0.5).to(dev)
    init8 = torch.where(
        m8, torch.arange(m8.numel(), dtype=torch.int32,
                         device=dev).reshape(FLOOD_8_GRID),
        torch.full(FLOOD_8_GRID, -1, dtype=torch.int32, device=dev))
    for periodic in (False, True):
        equal("flood_fill", [gk.propagate_fixpoint(init8, periodic)],
              [gk.propagate_fixpoint_plain(init8, periodic)],
              f"{FLOOD_8_GRID} random mask, periodic {periodic}")
        flood.append((f"{FLOOD_8_GRID} random 50%, "
                      f"{'periodic' if periodic else 'open'}, linear init",
                      init8, periodic))
    say(f"flood fill: equal to plain on {FLOOD_8_GRID} too "
        f"({int(m8.sum())} voxels, open and periodic)")
    # the calls are host-bound (0.03-0.05 ms of host time each on the H100
    # machine): 50 calls a case
    flood_ms = {}
    for what, init, periodic in flood:
        flood_ms[what] = cuda_ms(
            lambda: gk.propagate_fixpoint(init, periodic), reps=50, warmup=5)
        say(f"kernel flood_fill on {what}: {flood_ms[what]:.4f} ms/call "
            f"(CUDA events, 50 calls) on {card}")
    open_init = flood[0][1]
    timed("flood_fill", lambda: gk.propagate_fixpoint(open_init, False),
          lambda: gk.propagate_fixpoint_plain(open_init, False), reps=50)
    work["flood_fill"] = (8 * n_vox, 6 * n_vox)
    geo = gk.flood_fill_geometry(grid)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for step in gk.FLOOD_STEPS:
        g = geo[step]
        say(f"geometry flood_fill {step}: {g['blocks']} blocks of "
            f"{g['threads']} threads, {g['smem_bytes']} B static shared, "
            f"{g['registers']} registers, {g['blocks_per_sm']} blocks/SM on "
            f"{sms} SMs: {g['blocks'] / (g['blocks_per_sm'] * sms):.2f} "
            f"waves; {len(gk.FLOOD_STEPS)} launches a call, tile "
            f"{geo['tile']} (grid {grid})")

    # kernel #6 on three inputs: bench frame 0 under its channel mask (the
    # pore step's call), bench frame 0 with every atom, and the void slab
    # under its channel mask (a surface with real work)
    n_z = -(-sp["col_cap"] // sp["chunk"])
    surf_ms, surf = {}, {}
    for what, inp, cand in (
            ("bench frame 0, prefiltered", cases[0][1], m_chan),
            ("bench frame 0, every atom", cases[0][1], None),
            ("void-slab frame 0, prefiltered", cases[3][1],
             chan["void-slab frame 0"])):
        frac, cell, inv, radii, dirs, _ = inp
        sv = (frac, cell, radii, 1.2, dirs, grid, sp["nbx"], sp["nby"],
              sp["window"], sp["chunk"], sp["col_cap"])
        got = sk.surface_valid_columns(*sv, cand_mask=cand, inv_cell=inv)
        ref = gk.surface_valid_columns(*sv, cand_mask=cand, inv_cell=inv)
        torch.cuda.synchronize()
        equal("surface_valid_columns", got, ref, what)
        slay = gk.surface_layout(frac, inv, radii, 1.2, dirs, grid,
                                 sp["nbx"], sp["nby"], sp["window"],
                                 sp["col_cap"], cand)
        sa = (slay, cell, inv, dirs, 1.2, grid, sp["nbx"], sp["nby"], n_z,
              sp["chunk"])
        n_bytes, ops, all_ops, cnt = surface_work(slay, cell, dirs, sp, n_z)
        surf[what] = (sa, n_bytes, ops, all_ops)
        say(f"surface, {what}: {cnt['slots']} of "
            f"{sp['nbx'] * sp['nby'] * n_z} slots active, {cnt['groups']} "
            f"groups; {cnt['cand']} candidate and {cnt['non_cand']} "
            f"non-candidate centers in active slots; rows kept a group "
            f"{cnt['kept_mean']:.1f} (min {cnt['kept_min']}, max "
            f"{cnt['kept_max']}) of {cnt['rows_mean']:.1f}; tests an item "
            f"{cnt['tests_cut']:.1f} with the cut, {cnt['tests_all']:.1f} "
            f"over all rows; {cnt['pairs']} (point, blocker) pairs within "
            f"reach; {int(ref[0].sum())} valid points (equal to plain)")
        surf_ms[what] = cuda_ms(lambda: sk._launch_surface(*sa), reps=10,
                                warmup=2)
        say(f"kernel surface_valid_columns on {what}: "
            f"{surf_ms[what]:.4f} ms/call (CUDA events, 10 calls) on {card}")
    what = "bench frame 0, prefiltered"
    sa, n_bytes, ops, all_ops = surf[what]
    timed("surface_valid_columns", lambda: sk._launch_surface(*sa),
          lambda: gk.surface_valid_tiles_plain(*sa[:8], sp["window"], n_z,
                                               sp["chunk"]))
    dev_us = device_us(lambda: sk._launch_surface(*sa), "surface_columns",
                       reps=10)
    say(f"kernel surface_valid_columns on {what}: device "
        f"{dev_us if dev_us is None else round(dev_us, 2)} us/call "
        f"(torch.profiler, 10 calls) on {card}")
    work["surface_valid_columns"] = (n_bytes, ops)
    surf_all_ms = bound(n_bytes, all_ops)[0]
    say(f"surface_valid_columns work ({what}): {n_bytes:.4e} B, {ops:.4e} "
        f"f32 ops over the pairs within reach; every row: {all_ops:.4e} "
        f"ops, bound {surf_all_ms:.4f} ms")
    sgeo = sk.surface_columns_geometry(sp["nbx"] * sp["nby"])
    say(f"geometry surface_valid_columns: {sgeo['blocks']} blocks (a "
        f"persistent grid over the groups) of {sgeo['threads']} threads, "
        f"{sgeo['smem_bytes']} B shared ({sgeo['cap_rows']} rows a flush), "
        f"{sgeo['registers']} registers, "
        f"{sgeo['blocks_per_sm']} blocks/SM on {sms} SMs: "
        f"{sgeo['blocks'] / (sgeo['blocks_per_sm'] * sms):.2f} waves")
    extras = {
        "void_masks_points": {"bound_ms_all_rows": all_rows_ms},
        "flood_fill": {"cases_ms": flood_ms, "geometry": geo},
        "surface_valid_columns": {
            "bound_ms_all_rows": surf_all_ms, "cases_ms": surf_ms,
            "device_us": dev_us, "geometry": sgeo}}
    return res, work, extras


def pore_main(pb, dev):
    """Phase 4, pore: BatchedPore.run at the bench configuration, counted
    on its own. Returns (records, meta, launches, seconds)."""
    import numpy as np
    import torch

    from amof_tpu_torch.pore import BatchedPore

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records, meta = BatchedPore(**PORE).run(pb, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    say(f"pore main path launches: "
        f"{ {k: launches[k] for k in PORE_PATH} }")
    for name in PORE_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the pore main path")
    check(len(records) == pb.num_frames, "pore: one record per frame")
    for r in records:
        check(all(np.isfinite(v) for v in r.values()), "pore: not finite")
        check(r["ASA_A^2"] >= 0 and r["AV_A^3"] >= 0, "pore: negative")
    means = {key: float(np.mean([r[key] for r in records]))
             for key in ("ASA_A^2", "NASA_A^2", "AV_A^3", "NAV_A^3",
                         "AV_Volume_fraction")}
    say(f"pore records ({pb.num_frames} frames, grid {meta['grid']}, "
        f"K {meta['k']}): means {means} ({wall:.2f} s cold)")
    return records, meta, launches


def pore_side_run(batch, dev, n_frames=4):
    """The glass with z squeezed into 72% of the box: channels percolate
    and the surface pass has real work. Counted apart."""
    from amof_tpu_torch.pore import BatchedPore

    reset_launches()
    slab = pore_batch_of(batch, n_frames, squeeze=0.72)
    records, _ = BatchedPore(**PORE).run(slab, device=dev)
    side = read_launches()
    for r in records:
        check(r["ASA_A^2"] > 0 and r["AV_A^3"] > 0,
              f"void slab: ASA {r['ASA_A^2']} AV {r['AV_A^3']}")
    say(f"void-slab side run ({n_frames} frames): ASA "
        f"{records[0]['ASA_A^2']:.1f} A^2, NASA {records[0]['NASA_A^2']:.1f},"
        f" AV {records[0]['AV_A^3']:.1f} A^3, NAV "
        f"{records[0]['NAV_A^3']:.1f}; launches "
        f"{ {k: side[k] for k in PORE_PATH} }")
    return side


def pore_cpu_parity(dev, n_atoms=2048, n_frames=2):
    """Phase 5, pore: a 2048-atom glass (bench recipe, void slab) on the
    card against the plain versions on the CPU: masks, labels, fits and
    per-atom validity equal; the ``Pore`` entry point's records to rel
    1e-5 (sums in another order)."""
    import numpy as np
    import torch

    from amof_tpu_torch.pore import BatchedPore
    from amof_tpu_torch.pore import grid_kernel as gk
    from amof_tpu_torch.pore import surface_kernel as sk
    from amof_tpu_torch.pore.core import pore_records

    t0 = time.perf_counter()
    small, _ = make_trajectory(n_frames, n_atoms, seed=3)
    small = pore_batch_of(small, n_frames, squeeze=0.72)
    bp = BatchedPore(**PORE)
    _, _, meta = bp.prepare(small, device="cpu")
    cp, sp = meta["col_plan"], meta["surf_plan"]
    outs = {}
    for d in (dev, torch.device("cpu")):
        frac, cell, inv, radii, dirs, pts = pore_frame_inputs(small, meta, d)
        m = sk.void_masks_points(frac, cell, radii, cp["grid"], 1.2, 1.2,
                                 cp["nbx"], cp["nby"], cp["window"], pts)
        cls = gk.void_classification_mask(m[1])
        lab = gk.label_components(m[1], periodic=False)
        sv = sk.surface_valid_columns(
            frac, cell, radii, 1.2, dirs, cp["grid"], sp["nbx"], sp["nby"],
            sp["window"], sp["chunk"], sp["col_cap"], cand_mask=m[1],
            inv_cell=inv)
        outs[d.type] = [t.cpu() for t in (*m, lab, *cls, *sv)]
    for i, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
        check(torch.equal(g, c), f"pore card != CPU (output {i}: "
              f"{int((g != c).sum())} items differ)")
    gpu = pore_records(small, small.step, device=dev, **PORE)
    cpu = pore_records(small, small.step, device="cpu", **PORE)
    worst = 0.0
    for a, b in zip(gpu, cpu):
        for key in a:
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            worst = max(worst, rel)
            check(rel <= 1e-5, f"pore {key}: card {a[key]} vs CPU {b[key]}")
    say(f"pore card == CPU plain on a {n_atoms}-atom void-slab glass: masks,"
        f" fits, labels, classification, per-atom validity and indices "
        f"equal; records max rel diff {worst:.2e} "
        f"(ASA {gpu[0]['ASA_A^2']:.1f}, AV {gpu[0]['AV_A^3']:.1f}; "
        f"{time.perf_counter() - t0:.1f} s)")


# stages of the pore step timed by pore_stage_split: (module, attribute,
# label); "frame (all)" contains the others, "surface pass" contains the
# layout, the prefilter and kernel #6
PORE_STAGES = [
    ("amof_tpu_torch.pore.batch", "_frame", "frame (all)"),
    ("amof_tpu_torch.pore.surface_kernel", "void_masks_points",
     "masks (#5)"),
    ("amof_tpu_torch.pore.grid_kernel", "void_classification_mask",
     "classification (2x #7)"),
    ("amof_tpu_torch.pore.batch", "_volume", "MC volume"),
    ("amof_tpu_torch.pore.surface_kernel", "surface_valid_columns",
     "surface pass (all)"),
    ("amof_tpu_torch.pore.grid_kernel", "surface_candidate_mask",
     "candidate prefilter"),
    ("amof_tpu_torch.pore.surface_kernel", "_launch_surface",
     "surface kernel (#6)"),
    ("amof_tpu_torch.pore.batch", "_surface_sums", "classify + sums"),
]


def stage_table(stages, run, n, title):
    """Host ms/frame of each stage of ``run()``, each call bracketed by
    torch.cuda.synchronize() (which inflates the total)."""
    import importlib

    import torch

    spent = {label: 0.0 for _, _, label in stages}
    calls = dict.fromkeys(spent, 0)
    saved = []

    def timed(fn, label):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[label] += time.perf_counter() - t0
                calls[label] += 1
        return wrapper

    for mod_name, attr, label in stages:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), label))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    lines = [f"{title}, {n} frames, synced stages: wall {wall:.3f} s = "
             f"{1e3 * wall / n:.3f} ms/frame"]
    lines += [f"  {label:<24s} {1e3 * spent[label] / n:8.3f} ms/frame  "
              f"calls {calls[label]}" for _, _, label in stages]
    return lines


def pore_times(pb, dev, card):
    """Phase 6, pore: prepare time and ms/frame of the step (host clock
    around a synchronize; best of two runs after prepare); phase 7: the
    stage split. Returns (ms_per_frame, prepare_s, first-pass misses)."""
    import torch

    from amof_tpu_torch.pore import BatchedPore

    bp = BatchedPore(**PORE)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn, args, _ = bp.prepare(pb, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        runs.append((t1 - t0, time.perf_counter() - t1))
    prep = min(r[0] for r in runs)
    step = min(r[1] for r in runs)
    misses = int(out[4].sum())
    ms = 1e3 * step / pb.num_frames
    say(f"pore step: {step:.3f} s for {pb.num_frames} frames = {ms:.3f} "
        f"ms/frame ({pb.num_frames / step:.1f} frames/s; prepare "
        f"{prep:.3f} s; runs {runs}; first-pass misses {misses}) on {card}")
    profiled(lambda: step_fn(*args), pb.num_frames, "pore profile",
             "chip_smoke_pore_profile.txt")
    lines = stage_table(PORE_STAGES, lambda: step_fn(*args), pb.num_frames,
                        "pore stage split")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_pore_stages.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for line in lines:
        say(line)
    return ms, prep, misses


# --------------------------------------------------------------------------
# The per-frame pore path (zeopp) and BatchedPore's distance-field plans
# --------------------------------------------------------------------------

PER_FRAME_FULL = dict(sa=True, vol=True, res=True, chan=True, psd=True,
                      volpo=True)
FULL_FIELD_LIMIT_S = 120.0  # past this, the full-field call is cut to 0.25 A
EXCERPT_RES = 0.5
EXTRA = "-oms -axs 1.5 -strinfo -gridG"


def timed_call(label, fn, card, rows):
    """``fn()`` on the card with the launch counters zeroed just before it
    and read just after it: wall s (host clock around a synchronize),
    kernel #7's launches (which must be > 0) and the peak device memory,
    printed and appended to ``rows``. Returns fn's result."""
    import torch

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"per-frame {label}: {wall:.3f} s, flood_fill launches "
        f"{launches['flood_fill']}, peak {peak:.2f} GiB on {card}")
    check(launches["flood_fill"] > 0,
          f"kernel flood_fill was not launched on per-frame {label}")
    rows.append({"call": label, "s": wall,
                 "flood_fill_launches": launches["flood_fill"],
                 "peak_gib": peak})
    return out


def scalars(out):
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in out.items() if not hasattr(v, "shape")}


# stages of the per-frame path timed by per_frame_stages: (module,
# attribute, label); "call (all)" contains the others, the exact
# classification contains its labels
PER_FRAME_STAGES = [
    ("amof_tpu_torch.pore.zeopp", "analyze_frame", "call (all)"),
    ("amof_tpu_torch.pore.grid_kernel", "distance_grid_windowed",
     "windowed field"),
    ("amof_tpu_torch.pore.grid_kernel", "distance_grid", "full field"),
    ("amof_tpu_torch.pore.winding", "void_classification_exact",
     "exact classification"),
    ("amof_tpu_torch.pore.grid_kernel", "label_components", "labels (#7)"),
    ("amof_tpu_torch.pore.grid_kernel",
     "surface_point_classification_windowed", "surface (windowed)"),
    ("amof_tpu_torch.pore.grid_kernel", "covering_volume_counts",
     "covering FFTs (-psd)"),
    ("amof_tpu_torch.pore.grid_kernel", "dilate", "dilation (-volpo)"),
]


def per_frame_stages(batch, slab, dev):
    """Phase 7, per-frame path: the -sa -vol call on bench frame 0 and
    the full-options call on the void slab once more, each piece
    bracketed by a synchronize (host s; the table goes to OUT_DIR)."""
    from amof_tpu_torch.pore import zeopp

    lines = stage_table(PER_FRAME_STAGES, lambda: zeopp.analyze_frame(
        batch.frame(0), sa=True, vol=True, device=dev), 1,
        "per-frame -sa -vol, bench frame 0")
    lines += stage_table(PER_FRAME_STAGES, lambda: zeopp.analyze_frame(
        slab.frame(0), device=dev, **PER_FRAME_FULL), 1,
        "per-frame -sa -vol -res -chan -psd -volpo, void slab")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_per_frame_stages.txt"),
              "w") as fh:
        fh.write("\n".join(lines) + "\n")
    for line in lines:
        say(line)


def first_mask_of(fn, store):
    """``fn()`` with the first mask that the per-frame path's exact
    classification (``winding.void_classification_exact``) gets appended
    to ``store``."""
    from amof_tpu_torch.pore import winding

    classify = winding.void_classification_exact

    def recording(mask, *args, **kwargs):
        if not store:
            store.append(mask)
        return classify(mask, *args, **kwargs)

    winding.void_classification_exact = recording
    try:
        return fn()
    finally:
        winding.void_classification_exact = classify


def per_frame_flood_check(what, mask):
    """Kernel #7 against its plain version on a per-frame call's own
    channel mask (276^3 at 0.2 A): the open-boundary labels of the
    linear-index init (the exact classification's call) and the periodic
    {1, 0, -1} init of their winding seeds. Fails on any differing
    voxel."""
    import torch

    from amof_tpu_torch.pore import grid_kernel as gk

    mask = mask.bool()
    dev = mask.device
    open_init = torch.where(
        mask, torch.arange(mask.numel(), dtype=torch.int32,
                           device=dev).reshape(mask.shape),
        torch.full(mask.shape, -1, dtype=torch.int32, device=dev))
    t0 = time.perf_counter()
    lab = gk.propagate_fixpoint(open_init, False)
    ref = gk.propagate_fixpoint_plain(open_init, False)
    check(torch.equal(lab, ref),
          f"flood_fill != plain on the per-frame mask of {what}, open "
          f"boundaries ({int((lab != ref).sum())} voxels differ)")
    seeds = gk.winding_seeds(lab, mask)
    tern = torch.where(seeds, 1, torch.where(mask, 0, -1)).to(torch.int32)
    acc = gk.propagate_fixpoint(tern, True)
    ref = gk.propagate_fixpoint_plain(tern, True)
    check(torch.equal(acc, ref),
          f"flood_fill != plain on the per-frame mask of {what}, periodic "
          f"ternary init ({int((acc != ref).sum())} voxels differ)")
    say(f"flood fill on the per-frame mask of {what} "
        f"{tuple(mask.shape)}: {int(mask.sum())} void voxels, "
        f"{int(seeds.sum())} winding seeds, open and periodic labels equal "
        f"to plain ({time.perf_counter() - t0:.1f} s)")


def per_frame_phase(batch, dev, card):
    """Phase 4, the per-frame pore path, each call counted on its own:
    (1) ``zeopp.analyze_frame(-sa -vol)`` at its defaults (resolution
    0.2 A: 276^3 voxels, the sorted-window field) on bench frames 0-1 and
    void-slab frame 0, the call ``BatchedPore``'s terminal fallback makes,
    with kernel #7 held against its plain version on the channel masks
    of bench frame 0 and void-slab frame 0 (``per_frame_flood_check``);
    (2) ``zeopp.network`` on void-slab frame 0 with -sa -vol -res -chan
    -psd -volpo at 0.2 A (-res and -psd take the full O(V N) field), cut
    to 0.25 A if it took longer than FULL_FIELD_LIMIT_S; (3) -block,
    -ray_atom and the extras on the 2048-atom excerpt at 0.5 A; (4)
    ``BatchedPore``'s distance-field plans: explicit grid= (grid mode and
    mc) and window=None on the excerpt, the two-level field on bench
    frames 0-1 at an explicit 276^3 grid (where window="auto" engages it),
    and winding="exact" on the void slab (column plan). Returns the rows
    for the JSON line."""
    import numpy as np

    from amof_tpu_torch.pore import BatchedPore, zeopp

    rows = []
    slab = pore_batch_of(batch, 1, squeeze=0.72)
    for label, frame in (("sa vol, bench frame 0", batch.frame(0)),
                         ("sa vol, bench frame 1", batch.frame(1)),
                         ("sa vol, void-slab frame 0", slab.frame(0))):
        masks = []
        out = timed_call(label, lambda: first_mask_of(
            lambda: zeopp.analyze_frame(frame, sa=True, vol=True,
                                        device=dev), masks), card, rows)
        check(all(np.isfinite(v) for v in out.values()),
              f"per-frame {label}: not finite")
        say(f"per-frame {label}: {scalars(out)}")
        if "frame 0" in label:
            per_frame_flood_check(label, masks[0])
    out = timed_call("full options (res chan psd volpo), void slab, 0.2 A",
                     lambda: zeopp.network(slab.frame(0), device=dev,
                                           **PER_FRAME_FULL), card, rows)
    say(f"per-frame full options at 0.2 A: {scalars(out)}")
    check(out["Number_of_channels"] >= 1 and out["AV_A^3"] > 0,
          "void slab: no channel at 0.2 A")
    if rows[-1]["s"] > FULL_FIELD_LIMIT_S:
        out = timed_call(
            "full options (res chan psd volpo), void slab, 0.25 A (cut)",
            lambda: zeopp.network(slab.frame(0), device=dev,
                                  resolution=0.25, **PER_FRAME_FULL),
            card, rows)
        say(f"per-frame full options at 0.25 A: {scalars(out)}")

    small = per_frame_excerpt()
    out = timed_call("block ray_atom extras, excerpt, 0.5 A",
                     lambda: zeopp.network(
                         small.frame(0), device=dev, sa=True, block=True,
                         ray_atom=True, resolution=EXCERPT_RES,
                         extra=EXTRA), card, rows)
    say(f"per-frame block/ray/extras: {scalars(out)}")
    check(out["RayAtom_samples"] > 0, "excerpt: no ray")

    for label, pb, kw in (
            ("BatchedPore grid=, excerpt", small,
             dict(grid=(64, 64, 64))),
            ("BatchedPore grid= mc, excerpt", small,
             dict(grid=(64, 64, 64), vol_method="mc")),
            ("BatchedPore window=None, excerpt", small,
             dict(window=None, resolution=EXCERPT_RES)),
            ("BatchedPore two-level field, bench frames 0-1",
             pore_batch_of(batch, 2), dict(grid=(276, 276, 276))),
            ("BatchedPore winding=exact, void slab (column plan)",
             pore_batch_of(batch, 4, squeeze=0.72),
             dict(PORE, winding="exact"))):
        records, meta = timed_call(label, lambda: BatchedPore(**kw).run(
            pb, device=dev), card, rows)
        for r in records:
            check(all(np.isfinite(v) for v in r.values()),
                  f"{label}: not finite")
        rows[-1].update(dist_window=meta["dist_window"],
                        surf_window=meta["surf_window"],
                        dist2=meta["dist2"],
                        column_plan=meta["col_plan"] is not None)
        say(f"{label}: ASA {records[0]['ASA_A^2']:.1f} A^2, AV "
            f"{records[0]['AV_A^3']:.1f} A^3; windows {meta['dist_window']}"
            f" / {meta['surf_window']}, dist2 {meta['dist2']}")
        if "two-level" in label:
            check(meta["dist2"] is not None, "the two-level field did not "
                  "engage at 276^3 on the bench frame")
        if "winding" in label:
            face, _ = BatchedPore(**PORE).run(pb, device=dev)
            check(face == records, "winding=exact records differ from the "
                  "face test's on the void slab")
    per_frame_stages(batch, slab, dev)
    return rows


def per_frame_excerpt():
    """The 2048-atom excerpt of the card == CPU checks (bench recipe, seed
    3, z squeezed to 72%), two frames."""
    small, _ = make_trajectory(2, 2048, seed=3)
    return pore_batch_of(small, 2, squeeze=0.72)


def equal_on(label, got, ref, rel=None):
    """Card and CPU outputs equal (tensors, arrays), or scalars within
    ``rel``."""
    import numpy as np
    import torch

    if isinstance(got, torch.Tensor):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if isinstance(got, np.ndarray):
        diff = int((got != ref).sum()) if got.shape == ref.shape else -1
        check(diff == 0, f"per-frame card != CPU: {label} ({diff} items "
              f"differ)")
    elif isinstance(got, float) and rel is not None:
        check(abs(got - ref) <= rel * max(abs(ref), 1e-30),
              f"per-frame card != CPU: {label}: {got} vs {ref}")
    else:
        check(got == ref, f"per-frame card != CPU: {label}: {got} vs {ref}")


def per_frame_cpu_parity(dev):
    """Phase 5, per-frame path: the 2048-atom excerpt on the card against
    the port's own CPU path. The fields (full, one-level and two-level
    window, MC points), the exact classification, both surface
    classifications, the covering counts and ray chords equal; every
    option's result (arrays equal, scalars rel 1e-5) and BatchedPore's
    distance-field records (rel 1e-5) agree."""
    import numpy as np
    import torch

    from amof_tpu_torch.data import elements
    from amof_tpu_torch.pore import BatchedPore, winding, zeopp
    from amof_tpu_torch.pore import grid_kernel as gk

    t0 = time.perf_counter()
    small = per_frame_excerpt()
    frame = small.frame(0)
    cell = frame.get_cell().astype(np.float32)
    grid = zeopp._grid_dims(cell, EXCERPT_RES)
    frac = frame.get_positions() @ np.linalg.inv(cell.astype(np.float64))
    frac = (frac - np.floor(frac)).astype(np.float32)
    radii = elements.vdw_radius_array()[frame.get_atomic_numbers()].astype(
        np.float32)
    pts = np.random.default_rng(20240817).random((8192, 3)).astype(
        np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    outs = []
    for d in (dev, torch.device("cpu")):
        f, c, r, p = (torch.from_numpy(a).to(d) for a in (frac, cell, radii,
                                                           pts))
        full = gk.distance_grid(f, c, r, grid)
        win = gk.distance_grid_windowed(f, c, r, grid, dmax=1.201, dxa=0.095,
                                        chunk=2048, window=768)
        win2 = gk.distance_grid_windowed2(
            f, c, r, (64, 64, 64), dmax=1.201, dxa=0.095, dya=0.095, tvx=8,
            tvy=16, nbx=5, k_slabs=3, window=384)
        pdist = gk.point_distance_windowed(
            f, c, r, p, p[::2048, 0].contiguous(),
            p[2047::2048, 0].contiguous(), dmax=1.201, dxa=0.095,
            chunk=2048, window=896)
        cls = winding.void_classification_exact(full >= 1.2)
        dirs = torch.from_numpy(gk.fibonacci_sphere(24)).to(d)
        surf = gk.surface_point_classification(f, c, r, 1.2, dirs, cls[1],
                                               cls[2], grid)
        surf_w = gk.surface_point_classification_windowed(
            f, c, r, 1.2, dirs, cls[1], cls[2], grid, window=640)
        cover = gk.covering_volume_counts(
            full, cls[1], cls[1], c,
            (0.05 * np.arange(64)).astype(np.float32), grid)
        chords = gk.ray_chord_lengths(full, p[:4096], p[4096:] - 0.5, c,
                                      0.0, grid)
        outs.append([full, *win, *win2, *pdist, *cls, *surf, *surf_w, cover,
                     chords])
    for i, (g, c) in enumerate(zip(*outs)):
        equal_on(f"field/classification output {i}", g, c)
    kw = dict(resolution=EXCERPT_RES, block=True, ray_atom=True,
              extra=EXTRA, **PER_FRAME_FULL)
    got = zeopp.network(frame, device=dev, **kw)
    ref = zeopp.network(frame, device="cpu", **kw)
    check(set(got) == set(ref), "per-frame card/CPU keys differ")
    for key in ref:
        equal_on(key, got[key], ref[key], rel=1e-5)
    worst = 0.0
    for kw in (dict(grid=(64, 64, 64)),
               dict(grid=(64, 64, 64), vol_method="mc"),
               dict(window=None, resolution=EXCERPT_RES, winding="exact")):
        gpu, _ = BatchedPore(**kw).run(small, device=dev)
        cpu, _ = BatchedPore(**kw).run(small, device="cpu")
        for a, b in zip(gpu, cpu):
            for key in a:
                rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                worst = max(worst, rel)
                check(rel <= 1e-5, f"BatchedPore {kw} {key}: card "
                      f"{a[key]} vs CPU {b[key]}")
    say(f"per-frame card == CPU plain on the {len(radii)}-atom excerpt: "
        f"fields (full, windowed, two-level, MC points), classification, "
        f"surface counts (full, windowed), covering counts and chords "
        f"equal; network(-sa -vol -res -chan -psd -volpo -block -ray_atom "
        f"{EXTRA}) equal; BatchedPore field plans max rel diff {worst:.2e} "
        f"({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# Trajectory I/O and ring statistics
# --------------------------------------------------------------------------

RING_DEPTH = 32  # max_search_depth; the adaptive loop stops at 16 here
RING_NET = dict(reps=4, n_frames=4, sigma=0.1, seed=0)  # 1536 nodes
RING_NET_LARGE_REPS = 8  # 12288 nodes: the dense BFS at 604 MB a matrix
IO_FRAMES = 32


def ring_fixtures():
    """``tests/ring_fixtures.py``, loaded by path: the decorated diamond
    net (``RING_CUTOFFS``, ``net_frames``), the spanning-ring frame and
    the scipy BFS oracle, the same inputs the CPU tests use."""
    import importlib.util

    if "ring_fixtures" not in sys.modules:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "ring_fixtures.py")
        spec = importlib.util.spec_from_file_location("ring_fixtures", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["ring_fixtures"] = module
    return sys.modules["ring_fixtures"]


def ring_engine_build(card):
    """Phase 2: g++'s version and the build of the ring engine
    (``amof_tpu_torch/native/ringsearch.cpp``) beside nvcc's time (the
    spans ``build.gxx`` and ``build.nvcc``)."""
    from amof_tpu_torch import native

    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    check(version, "g++ --version printed nothing")
    t0 = time.perf_counter()
    native.get_lib()
    load_s = time.perf_counter() - t0
    gxx_s, nvcc_s = span_seconds("build.gxx"), span_seconds("build.nvcc")
    say(f"ring engine: {version[0]}; "
        + (f"g++ ran: {gxx_s:.2f} s" if gxx_s is not None
           else "g++ did not run: loaded an existing build")
        + f" (load {load_s:.2f} s; {native.library_path().name}); nvcc "
        + (f"{nvcc_s:.1f} s" if nvcc_s else "did not run") + f" on {card}")
    return {"gxx": version[0], "gxx_s": gxx_s, "nvcc_s": nvcc_s}


def write_lammps_dump(path, batch):
    """``dump custom`` with ``id type x y z``, %.9g (exact for float32);
    types numbered in order of first appearance. Returns the specorder."""
    import numpy as np

    from amof_tpu_torch.data import elements

    zs = list(dict.fromkeys(batch.species.tolist()))
    index = {z: t for t, z in enumerate(zs)}
    types = np.array([index[z] for z in batch.species.tolist()])
    ids = np.arange(1, batch.num_atoms + 1)
    with open(path, "w") as f:
        for k in range(batch.num_frames):
            lo_hi = "".join(f"0 {float(batch.cell[k, a, a]):.9g}\n"
                            for a in range(3))
            f.write(f"ITEM: TIMESTEP\n{int(batch.step[k])}\n"
                    f"ITEM: NUMBER OF ATOMS\n{batch.num_atoms}\n"
                    f"ITEM: BOX BOUNDS pp pp pp\n{lo_hi}"
                    "ITEM: ATOMS id type x y z\n")
            rows = np.column_stack([ids, types + 1,
                                    batch.positions[k].astype(np.float64)])
            np.savetxt(f, rows, fmt=["%d", "%d", "%.9g", "%.9g", "%.9g"])
    return [elements.chemical_symbols[z] for z in zs]


def write_cp2k_files(xyz_path, cell_path, batch):
    """A CP2K position file (xyz frames with the ``i = ..`` comment) and
    its ``.cell`` file, %.9g."""
    import numpy as np

    from amof_tpu_torch.data import elements

    symbols = np.array([elements.chemical_symbols[z]
                        for z in batch.species.tolist()])
    with open(xyz_path, "w") as f, open(cell_path, "w") as c:
        c.write("#   Step   Time [fs]       Ax [Angstrom]       Ay [Angstrom]"
                "       Az [Angstrom]       Bx [Angstrom]       By [Angstrom]"
                "       Bz [Angstrom]       Cx [Angstrom]       Cy [Angstrom]"
                "       Cz [Angstrom]      Volume [Angstrom^3]\n")
        for k in range(batch.num_frames):
            step = int(batch.step[k])
            f.write(f"{batch.num_atoms}\n i = {step:8d}, time = "
                    f"{0.5 * step:12.3f}, E = -1.0\n")
            pos = batch.positions[k].astype(np.float64)
            np.savetxt(f, np.column_stack([symbols, *(
                [f"{v:.9g}" for v in pos[:, a]] for a in range(3))]),
                fmt="%s")
            cell = batch.cell[k].astype(np.float64)
            c.write(f"{step:8d} {0.5 * step:12.3f} "
                    + " ".join(f"{v:.9g}" for v in cell.ravel())
                    + f" {abs(np.linalg.det(cell)):.9g}\n")


def io_phase(batch, dev, card):
    """Phase 4, trajectory I/O: the first IO_FRAMES bench frames written
    as a LAMMPS ``dump custom`` and as a CP2K xyz + .cell pair, read back
    with ``trajectory.read_traj`` (format sniffed) and
    ``trajectory.read_cp2k_traj``. Positions, numbers and cells must
    equal the in-memory frames exactly (float32), and ``rdf.rdf_columns``
    on each read trajectory must equal the in-memory run, kernel #1
    launching (counters zeroed before, read after). Returns rows."""
    import tempfile

    import numpy as np
    import torch

    from amof_tpu_torch import rdf, trajectory

    part = excerpt(batch, IO_FRAMES)
    ref_cols = rdf.rdf_columns(part, dr=BENCH["dr"], device=dev)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "bench.lammpstrj")
        specorder = write_lammps_dump(dump, part)
        xyz = os.path.join(tmp, "bench-pos-1.xyz")
        cellf = os.path.join(tmp, "bench-1.cell")
        write_cp2k_files(xyz, cellf, part)
        for label, read, size in (
                ("lammps dump custom (read_traj, sniffed)",
                 lambda: trajectory.read_traj(dump, specorder=specorder)
                 .frames, os.path.getsize(dump)),
                ("cp2k xyz + .cell (read_cp2k_traj)",
                 lambda: trajectory.read_cp2k_traj(xyz, cellf),
                 os.path.getsize(xyz) + os.path.getsize(cellf))):
            t0 = time.perf_counter()
            frames = read()
            wall = time.perf_counter() - t0
            check(len(frames) == IO_FRAMES, f"{label}: {len(frames)} frames")
            back = trajectory.Trajectory(frames).to_batch()
            for key in ("positions", "cell", "species"):
                got, want = getattr(back, key), getattr(part, key)
                check(got.dtype == want.dtype and np.array_equal(got, want),
                      f"{label}: {key} differ from the in-memory frames")
            reset_launches()
            cols = rdf.rdf_columns(back, dr=BENCH["dr"], device=dev)
            torch.cuda.synchronize()
            launches = read_launches()
            check(launches["rdf_counts_blocked"] > 0,
                  f"{label}: kernel rdf_counts_blocked not launched")
            check(list(cols) == list(ref_cols) and all(
                np.array_equal(cols[k], ref_cols[k]) for k in cols),
                f"{label}: rdf_columns differ from the in-memory run")
            mb = size / 1e6
            rows.append({"format": label, "s": wall, "MB": mb,
                         "MB_per_s": mb / wall,
                         "rdf_launches": launches["rdf_counts_blocked"]})
            say(f"io {label}: {IO_FRAMES} frames x {part.num_atoms} atoms, "
                f"{mb:.1f} MB read in {wall:.3f} s = {mb / wall:.1f} MB/s; "
                f"arrays equal, rdf_columns equal ({launches} launches) on "
                f"{card}")
    return rows


def census_run(frames, cutoffs, dev, depth=RING_DEPTH):
    """``Ring.census`` of ``frames``, synced, with the kernel counters,
    the ``ring.*`` spans and the peak device memory reset just before it
    and read just after. Returns (labeled array, reports, wall s, ms a
    frame by piece of the census, peak GiB, kernel launches)."""
    import torch

    from amof_tpu_torch import tracing
    from amof_tpu_torch.ring import Ring

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stacked, reports = Ring(max_search_depth=depth).census(
        frames, [cutoffs] * len(frames), list(range(len(frames))),
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    spans = tracing.diff(tracing.snapshot(), _launch_base)["spans"]
    split = {k[len("ring."):]: 1e3 * v[1] / len(frames)
             for k, v in spans.items() if k.startswith("ring.")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    return stacked, reports, wall, split, peak, launches


def ring_checked(label, stacked, reports, n_nodes, rc12, depth=16,
                 supercell=False, undiscovered=0):
    """RC(12), PN(12), the final depth, the supercell flag and the count
    of potentially undiscovered rings (None: not checked) of every frame
    of one census."""
    import numpy as np

    check(stacked is not None, f"ring {label}: no frame kept")
    sizes = list(stacked.get_coord("ring_size"))
    for k, rep in enumerate(reports):
        check(rep["Final search_depth"] == depth,
              f"ring {label} frame {k}: final depth "
              f"{rep['Final search_depth']}")
        check(rep["Supercell census"] == supercell,
              f"ring {label} frame {k}: supercell census "
              f"{rep['Supercell census']}")
        check(undiscovered is None
              or rep["Potentially undiscovered rings"] == undiscovered,
              f"ring {label} frame {k}: potentially undiscovered rings "
              f"{rep['Potentially undiscovered rings']}")
        if rc12 is not None:
            rc = np.asarray(stacked.sel(ring_var="RC"))[k]
            pn = np.asarray(stacked.sel(ring_var="PN"))[k]
            check(12 in sizes and rc[sizes.index(12)] == rc12
                  and pn[sizes.index(12)] == 1.0,
                  f"ring {label} frame {k}: RC(12) "
                  f"{rc[sizes.index(12)] if 12 in sizes else None}, "
                  f"expected {rc12} with PN(12) 1 ({n_nodes} nodes)")


def reduced_example():
    """``example_reduced.xyz``'s frame and the cutoff its
    ``.report_search.csv`` stores (read with the csv module: the card has
    no pandas)."""
    import ast
    import csv

    from amof_tpu_torch import trajectory

    frames = trajectory.read_traj("example_reduced.xyz").frames
    with open("example_reduced.report_search.csv") as f:
        row = next(csv.DictReader(f))
    return frames[0], ast.literal_eval(row["nb_set_and_cutoff"])


def ring_phase(dev, card):
    """Phase 4, ring statistics: ``Ring.census`` (the pandas-free half of
    ``compute_ring``) with {"Fr-Zn": 3.8} and max_search_depth 32 on the
    4x4x4 decorated diamond net (1536 nodes, 55.43 A, 4 frames of 0.1 A
    jitter from seed 0): RC(12) = 1024 and PN(12) = 1 on every frame,
    final depth 16, no supercell census, with the census's own split a
    frame (the ``ring.*`` spans). Side runs: ``Ring.census`` of one 8x8x8
    frame (12288 nodes, RC(12) = 8192, the same checks and split), the
    spanning-ring frame (the 2x2x2 supercell census must engage) and
    ``example_reduced`` with its stored cutoff. The kernel counters are
    zeroed before and read after each net run (no kernel of the nine is
    on this path). Returns the JSON entry."""
    from amof_tpu_torch.core.frames import Frame
    from amof_tpu_torch.ring import Ring

    fx = ring_fixtures()
    out = {}
    for key, label, frames in (
            ("net", "net 4x4x4", fx.net_frames(**RING_NET)),
            ("net_large", "net 8x8x8", fx.net_frames(RING_NET_LARGE_REPS))):
        n = len(frames[0])
        stacked, reports, wall, split, peak, launches = census_run(
            frames, fx.RING_CUTOFFS, dev)
        ring_checked(label, stacked, reports, n, 2 * n // 3)
        cert = reports[0]["Primitive shortcut exact up to size"]
        out[key] = {"nodes": n, "frames": len(frames), "s": wall,
                    "s_per_frame": wall / len(frames), "split_ms": split,
                    "peak_gib": peak, "kernel_launches": launches,
                    "certified": cert}
        say(f"ring {label} ({n} nodes, box {frames[0].cell[0, 0]:.2f} A): "
            f"{len(frames)} frames in {wall:.2f} s "
            f"({wall / len(frames):.3f} s/frame), RC(12) {2 * n // 3} and "
            f"PN(12) 1 on each, depth 16, certificate {cert}; kernel "
            f"launches {launches}; split ms a frame {fmt_ms(split)}; peak "
            f"{peak:.3f} GiB on {card}")
        del frames, stacked

    pos, numbers, cell, cutoffs = fx.spanning_ring_frame()
    t0 = time.perf_counter()
    stacked, reports = Ring(max_search_depth=8).census(
        [Frame(pos, numbers, cell)], [cutoffs], [0], device=dev)
    wall = time.perf_counter() - t0
    ring_checked("spanning ring", stacked, reports, 8, None, depth=8,
                 supercell=True, undiscovered=None)
    check(list(stacked.get_coord("ring_size")) == [8]
          and float(stacked.sel(ring_var="RC").values.ravel()[0]) == 1.0,
          "ring spanning ring: the 8-ring was not recovered")
    say(f"ring spanning-ring frame: supercell census engaged, RC(8) 1 "
        f"({wall:.2f} s)")

    frame, cutoffs = reduced_example()
    t0 = time.perf_counter()
    stacked, reports = Ring(max_search_depth=RING_DEPTH).census(
        [frame], [cutoffs], [0], device=dev)
    wall = time.perf_counter() - t0
    ring_checked("example_reduced", stacked, reports, len(frame), None,
                 supercell=True)
    sizes = [int(s) for s in stacked.get_coord("ring_size")]
    rc = [float(v) for v in stacked.sel(ring_var="RC").values.ravel()]
    out["example_reduced"] = {"nodes": len(frame), "ring_sizes": sizes,
                              "RC": rc, "s": wall}
    say(f"ring example_reduced ({len(frame)} nodes, {cutoffs}): sizes "
        f"{sizes}, RC {rc} ({wall:.2f} s)")
    return out


def fmt_ms(ms):
    return ", ".join(f"{k} {v:.2f}" for k, v in ms.items())


def census_equal(label, got, ref):
    """Two ``Ring.census`` results exactly equal: the array's coordinates
    and values, every key of every report."""
    import numpy as np

    (ga, gr), (ra, rr) = got, ref
    check((ga is None) == (ra is None), f"ring {label}: card != CPU (kept)")
    if ga is not None:
        for dim in ra.dims:
            check(np.array_equal(ga.get_coord(dim), ra.get_coord(dim)),
                  f"ring {label}: card != CPU ({dim})")
        check(np.array_equal(np.asarray(ga), np.asarray(ra)),
              f"ring {label}: card != CPU (RC, PN, Pmax, Pmin)")
    check(gr == rr, f"ring {label}: card != CPU reports {gr} vs {rr}")


def ring_cpu_parity(dev):
    """Phase 5, rings: the device BFS on frame 0 of the 4x4x4 net equals
    the scipy oracle; ``Ring.census`` on the card equals it on the CPU
    for that frame, the spanning-ring frame and ``example_reduced``;
    ``zeopp.network`` on a .cif written by ``io.cif.write_cif`` (the
    2048-atom excerpt, 0.5 A) equals ``network`` on the frame read back
    from it (the in-memory frame's difference is printed)."""
    import tempfile

    import numpy as np
    import torch

    from amof_tpu_torch import atom
    from amof_tpu_torch.core.frames import Frame
    from amof_tpu_torch.io.cif import read_cif, write_cif
    from amof_tpu_torch.ops import graph_kernel
    from amof_tpu_torch.pore import zeopp
    from amof_tpu_torch.ring import Ring, core

    fx = ring_fixtures()
    t0 = time.perf_counter()
    frame = fx.net_frames(RING_NET["reps"], 1, RING_NET["sigma"],
                          RING_NET["seed"])[0]
    adjacency, _ = core._frame_adjacency(
        frame, atom.format_cutoff(fx.RING_CUTOFFS, sort_pair=True))
    adj = core.adjacency_matrix(adjacency)
    got = graph_kernel.to_host_uint16(graph_kernel.bfs_distances(
        torch.from_numpy(adj).to(dev), 16))
    ref = fx.scipy_bfs(adj, 16)
    diff = int((got != ref).sum())
    check(diff == 0, f"device BFS != scipy oracle ({diff} entries)")
    say(f"ring BFS on the card == scipy shortest_path on net frame 0 "
        f"({len(adj)} nodes, depth 16, {int((ref < 0xFFFF).sum())} "
        f"reached pairs)")

    pos, numbers, cell, span_cut = fx.spanning_ring_frame()
    reduced, reduced_cut = reduced_example()
    for label, frm, cut, depth in (
            ("net frame 0", frame, fx.RING_CUTOFFS, RING_DEPTH),
            ("spanning ring", Frame(pos, numbers, cell), span_cut, 8),
            ("example_reduced", reduced, reduced_cut, RING_DEPTH)):
        census_equal(label, *(Ring(max_search_depth=depth).census(
            [frm], [cut], [0], device=d) for d in (dev, "cpu")))
    say("ring census card == CPU (arrays and every report key) on net "
        "frame 0, the spanning-ring frame and example_reduced")

    small = per_frame_excerpt().frame(0)
    kw = dict(sa=True, vol=True, resolution=EXCERPT_RES, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "excerpt.cif")
        write_cif(path, small)
        from_cif = zeopp.network(path, **kw)
        back = read_cif(path)
    on_frame = zeopp.network(back, **kw)
    check(from_cif == on_frame, f"network(.cif) {from_cif} != network("
          f"read_cif frame) {on_frame}")
    # the CIF keeps six decimals of each fractional coordinate, so the
    # frame read back is not the in-memory one: printed, not checked
    original = zeopp.network(small, **kw)
    worst = max(abs(from_cif[k] - original[k]) / max(abs(original[k]), 1e-30)
                for k in original)
    say(f"network(.cif) == network(frame read from it); vs the in-memory "
        f"frame max rel {worst:.2e} ({len(small)} atoms, {EXCERPT_RES} A; "
        f"{time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# The runtime warmup (kernel #9) and the cold start
# --------------------------------------------------------------------------

def warmup_phase(card):
    """Phase 2: ``amof_tpu_torch.warmup()`` in this cold process, then
    ``warmup(block=True)``; the warmup thread runs the nvcc build and
    launches kernel #9. Returns its launches."""
    from amof_tpu_torch import _build, warmup

    reset_launches()
    t0 = time.perf_counter()
    handle = warmup()
    t_return = time.perf_counter() - t0
    warmup(block=True)
    t_block = time.perf_counter() - t0
    check(handle is not None and handle.error is None, "warmup failed")
    launches = read_launches()
    check(launches["warmup_copy"] == 1,
          f"warmup launched warmup_copy {launches['warmup_copy']} times")
    nvcc_s = span_seconds("build.nvcc")
    how = (f"nvcc ran: {nvcc_s:.1f} s" if nvcc_s
           else "nvcc did not run: loaded an existing build")
    say(f"warmup(): returned after {1e3 * t_return:.1f} ms; warmup("
        f"block=True) done {t_block:.2f} s after the first call ({how}; "
        f"build.library {span_seconds('build.library'):.2f} s; "
        f"{_build.library_path().name}) on {card}")
    return launches


def cold_start_child(mode):
    """One cold process (``python3 chip_smoke.py --cold-start MODE``),
    building into a fresh directory; prints ``COLD {json}``.

    ``stages``: nvcc build, dlopen, CUDA context, first and second launch
    of kernel #9, each timed alone; then ``FusedAnalysis.prepare`` and its
    step on a 2-frame excerpt, where the warmup must launch kernel #9 once
    more. ``fused_cold`` / ``fused_warm``:
    ``FusedAnalysis.prepare`` + the first result at bench.py's
    configuration, without (``AMOF_TPU_NO_WARMUP``) and with the warmup
    overlapping ``prepare``'s host work."""
    import pathlib
    import shutil

    import torch

    from amof_tpu_torch import _build, tracing
    from amof_tpu_torch.warmup import warmup_copy

    def copies():
        return tracing.snapshot()["counts"].get("launch.warmup_copy", 0)

    out = {"mode": mode}
    build_dir = pathlib.Path(_build.BUILD_DIR) / f"cold_{mode}_{os.getpid()}"
    _build.BUILD_DIR = build_dir
    try:
        if mode == "stages":
            for key, fn in (
                ("build_s", _build.build),
                ("load_s", _build.library),
                ("context_s", lambda: torch.zeros(1, device="cuda")),
            ):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                out[key] = time.perf_counter() - t0
            src = torch.ones((8, 128), device="cuda")
            torch.cuda.synchronize()
            for key in ("first_launch_s", "second_launch_s"):
                t0 = time.perf_counter()
                warmup_copy(src)
                torch.cuda.synchronize()
                out[key] = time.perf_counter() - t0
            from amof_tpu_torch.parallel.pipeline import FusedAnalysis

            before = copies()
            small, _ = make_trajectory(2, 2048, seed=3)
            step_fn, args, _ = FusedAnalysis(
                CUTOFFS, **{**BENCH, "frames_per_call": 2}).prepare(
                small, device="cuda")
            step_fn(*args)
            out["prepare_warmup_launches"] = copies() - before
        else:
            from amof_tpu_torch.parallel.pipeline import FusedAnalysis

            if mode == "fused_cold":
                os.environ["AMOF_TPU_NO_WARMUP"] = "1"
            batch, _ = make_trajectory(256, 10240)
            t0 = time.perf_counter()
            step_fn, args, _ = FusedAnalysis(CUTOFFS, **BENCH).prepare(
                batch, device="cuda")
            out["prepare_s"] = time.perf_counter() - t0
            step_fn(*args)
            torch.cuda.synchronize()
            out["first_result_s"] = time.perf_counter() - t0
            out["nvcc_s"] = span_seconds("build.nvcc")
        out["warmup_launches"] = copies()
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    print("COLD " + json.dumps(out), flush=True)


def cold_start(card, pairs=False):
    """Phase 2, cold start: the ``stages`` child; with ``pairs`` (``python3
    chip_smoke.py --cold-start-pairs``, not part of the smoke run) also
    bench.py's fused step from a cold process in turns without, with,
    with and without the warmup. One child at a time."""
    rows = []
    modes = ("stages",) + (("fused_cold", "fused_warm", "fused_warm",
                            "fused_cold") if pairs else ())
    for mode in modes:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold-start", mode],
            capture_output=True, text=True, timeout=600,
        )
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("COLD ")]
        check(proc.returncode == 0 and lines,
              f"cold-start child {mode} failed ({proc.returncode}): "
              f"{proc.stderr[-2000:]}")
        row = json.loads(lines[-1][5:])
        row["process_s"] = time.perf_counter() - t0
        rows.append(row)
        say(f"cold start {mode}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "mode") + f" on {card}")
    check(rows[0]["prepare_warmup_launches"] == 1,
          "FusedAnalysis.prepare did not launch warmup_copy once")
    warm = [r for r in rows if r["mode"] == "fused_warm"]
    cold = [r for r in rows if r["mode"] == "fused_cold"]
    check(all(r["warmup_launches"] == 1 for r in warm),
          "the warmup did not launch warmup_copy once in FusedAnalysis")
    check(all(r["warmup_launches"] == 0 for r in cold),
          "AMOF_TPU_NO_WARMUP did not switch the warmup off")
    return rows


def host_path_us(src, reps=5000):
    """Host microseconds per call (perf_counter over ``reps`` calls after
    200 warm-up calls) of each piece of the kernel wrappers' launch path
    as ``warmup_copy`` takes it, and of the whole wrapper beside
    ``src.clone()`` and ``dst.copy_(src)``."""
    import torch

    from amof_tpu_torch import _build
    from amof_tpu_torch.warmup import warmup_copy

    dst = torch.empty_like(src)
    fn = _build.library().warmup_copy_launch
    sp, dp, n = src.data_ptr(), dst.data_ptr(), src.numel()
    stream = _build.stream_ptr(src)

    def checks():  # as warmup_copy makes them
        if src.is_cpu:
            return True
        ptr, n = src.data_ptr(), src.numel()
        return (src.dtype != torch.float32 or not src.is_contiguous()
                or n % 4 or ptr % 16)

    return time_host_pieces({
        "library()": _build.library,
        "stream_ptr": lambda: _build.stream_ptr(src),
        "bare ctypes launch": lambda: fn(sp, dp, n, stream),
        "checks": checks,
        "empty_like": lambda: torch.empty_like(src),
        "warmup_copy": lambda: warmup_copy(src),
        "src.clone()": src.clone,
        "dst.copy_(src)": lambda: dst.copy_(src),
    }, reps)


def time_host_pieces(pieces, reps):
    """Host microseconds a call of each of ``pieces`` (perf_counter over
    ``reps`` calls after 200 warm-up calls)."""
    import torch

    out = {}
    for name, call in pieces.items():
        for _ in range(200):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        out[name] = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
    return out


def warmup_kernel_check(dev, card):
    """Phase 3, kernel #9 against its plain version, and its launch path.
    Returns ((max_abs_err, ms, plain_ms), library_ms of ``src.clone()``,
    ms of ``dst.copy_(src)``, host us per piece, (bytes, ops))."""
    import numpy as np
    import torch

    from amof_tpu_torch import _build
    from amof_tpu_torch.warmup import SHAPE, warmup_copy, warmup_copy_plain

    src = torch.from_numpy(np.random.default_rng(9).normal(
        size=SHAPE).astype(np.float32)).to(dev)
    got, ref = warmup_copy(src), warmup_copy_plain(src)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "warmup_copy: kernel != plain")
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        check(_build.stream_ptr(src) == side.cuda_stream,
              "stream_ptr is not the side stream under torch.cuda.stream")
    check(_build.stream_ptr(src)
          == torch.cuda.current_stream(dev).cuda_stream
          == torch.cuda.default_stream(dev).cuda_stream,
          "stream_ptr is not the current stream")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: warmup_copy(src), reps=200, warmup=10)
    plain_ms = cuda_ms(lambda: warmup_copy_plain(src), reps=200, warmup=10)
    clone_ms = cuda_ms(src.clone, reps=200, warmup=10)
    copy_ms = cuda_ms(lambda: dst.copy_(src), reps=200, warmup=10)
    say(f"kernel warmup_copy: equal to plain; {ms:.4f} ms/call vs plain "
        f"{plain_ms:.4f}, src.clone() {clone_ms:.4f}, dst.copy_(src) "
        f"{copy_ms:.4f} ms/call (CUDA events, 200 calls) on {card}")
    host = host_path_us(src)
    say("launch path, host us/call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host.items()))
    return ((0.0, ms, plain_ms), clone_ms, copy_ms, host,
            (2 * 4 * src.numel(), 0))


# --------------------------------------------------------------------------
# The per-analysis entry points
# --------------------------------------------------------------------------

def excerpt(batch, n_frames):
    return batch._replace(positions=batch.positions[:n_frames],
                          cell=batch.cell[:n_frames],
                          step=batch.step[:n_frames])


def finite(name, cols):
    import numpy as np

    for key, col in cols.items():
        check(np.isfinite(np.asarray(col, np.float64)).all(),
              f"entry point {name}: column {key} not finite")


def entry_points(batch, box, pb, fused_out, fused_meta, dev, card):
    """Phase 4, entry points: each run on the bench trajectory with the
    launch counters zeroed just before it and read just after it. RDF, CN
    and BAD must equal what the fused step computed on the same frames.
    Returns ({entry: {kernel: launches}}, {entry: wall s})."""
    import numpy as np
    import torch

    from amof_tpu_torch import bad, cn, msd, rdf
    from amof_tpu_torch.ops import bad_kernel
    from amof_tpu_torch.pore.core import pore_records

    crowded = crowd_one_zn(excerpt(batch, 4), 2, box)
    window, time_fs = msd.msd_windows(batch.num_frames)
    steps = np.arange(batch.num_frames)
    runs = [
        ("rdf", 256, ("rdf_counts_blocked",),
         lambda: rdf.rdf_columns(batch, BENCH["dr"], device=dev)),
        ("rdf_cn", 4, ("rdf_counts",),
         lambda: rdf.rdf_cn_columns(excerpt(batch, 4), CUTOFFS, steps[:4],
                                    device=dev)),
        ("cn", 32, ("window_table",),
         lambda: cn.cn_columns(excerpt(batch, 32), CUTOFFS, steps[:32],
                               device=dev)),
        ("bad", 256, ("window_table_slab",),
         lambda: bad.bad_columns(batch, CUTOFFS, BENCH["dtheta"],
                                 device=dev)),
        ("bad_by_cn", 32, (),
         lambda: bad.bad_by_cn_dataset(excerpt(batch, 32), CUTOFFS,
                                       BENCH["dtheta"], device=dev)),
        ("bad_crowded", 4, ("window_table",),
         lambda: bad.bad_columns(crowded, CUTOFFS, BENCH["dtheta"],
                                 device=dev)),
        ("window_msd", 256, (),
         lambda: msd.msd_columns(batch, window, time_fs, device=dev)),
        ("pore", 32, PORE_PATH,
         lambda: pore_records(pb, pb.step, device=dev, **PORE)),
    ]
    res, launches, walls = {}, {}, {}
    for name, n, must, run in runs:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        got = read_launches()
        launches[name] = {k: v for k, v in got.items() if v}
        say(f"entry point {name} ({n} frames): {walls[name]:.3f} s on "
            f"{card}; launches {launches[name]}")
        for k in must:
            check(got[k] > 0, f"entry point {name}: kernel {k} was not "
                  "launched")

    for name in ("rdf", "rdf_cn", "cn", "bad", "bad_crowded", "window_msd"):
        finite(name, res[name])
    check(len(res["pore"]) == pb.num_frames, "pore: one record per frame")
    for r in res["pore"]:
        finite("pore", r)
    by_cn = res["bad_by_cn"]["bad"]
    check(by_cn.dims == ("atom_triple", "cn", "theta")
          and by_cn.values.size > 0, "BadByCn: empty or misshapen")
    # the entry points against the fused step on the same frames
    unique = np.unique(batch.species)
    ref_rdf = rdf.rdf_table(fused_out["rdf_counts"], batch.species, unique,
                            batch.num_frames, BENCH["dr"],
                            len(res["rdf"]["r"]))
    for key, col in ref_rdf.items():
        check(np.array_equal(res["rdf"][key], col),
              f"rdf column {key}: entry point != fused step")
    _, z_to_idx = rdf._species_table(batch.species)
    ref_cn = cn.cn_table(fused_out["cn_counts"][:32], batch.species, unique,
                         z_to_idx, CUTOFFS, steps[:32])
    for key, col in ref_cn.items():
        check(np.array_equal(res["cn"][key], col),
              f"cn column {key}: entry point != fused step")
    counts = [bad_kernel.select_spec_counts(
        fused_out["bad_concrete"].astype(np.float64),
        fused_out["bad_center_any"].astype(np.float64), s)
        for s in fused_meta["bad_specs"]]
    ref_bad = bad.bad_table(counts, fused_meta["bad_names"],
                            res["bad"]["theta"], BENCH["dtheta"])
    for key, col in ref_bad.items():
        check(np.array_equal(res["bad"][key], col),
              f"bad column {key}: entry point != fused step")
    say("entry points == fused step on the bench trajectory: RDF (256 "
        "frames), CN (32), BAD (256) columns equal")
    return launches, walls


def cn_passes(batch, dev, card, n_frames=32):
    """The first ``n_frames`` frames through the full O(N^2) pass
    (``pair_engine.frame_cn_counts`` a frame, called directly) and
    through ``cn.cn_columns`` as a user calls it on the card (the windowed
    pass: sorted windows and kernel #4 at K 32, the full pass again for
    the frames it flags); the columns must be equal. Host clock around a
    synchronize, the full pass timed first. Returns the times and the
    ``cn.*`` counters of the ``cn_columns`` call."""
    import numpy as np
    import torch

    from amof_tpu_torch import cn, tracing
    from amof_tpu_torch.ops import pair_engine

    sub = excerpt(batch, n_frames)
    steps = np.arange(n_frames)
    species = np.asarray(sub.species)
    unique, z_to_idx = cn._species_table(species)
    cut_np = cn._cutoff_matrix_for_species(CUTOFFS, unique, z_to_idx)
    positions, species_idx = pair_engine.pad_atoms(
        np.asarray(sub.positions, dtype=np.float32),
        z_to_idx[species].astype(np.int32))
    n_pad = positions.shape[1]
    chunk = pair_engine._pick_chunk(n_pad)
    cells = np.asarray(sub.cell, dtype=np.float32)
    window = cn.sorted_window(cells, float(cut_np.max()), n_pad, chunk)
    check(window is not None, "the bench frames should take a window")
    s = len(unique)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pos = torch.from_numpy(positions).to(dev)
    cells_t = torch.from_numpy(np.ascontiguousarray(cells)).to(dev)
    inv = pair_engine.inverse_cell(cells_t)
    sp = torch.from_numpy(species_idx).to(dev)
    cut = torch.from_numpy(cut_np).to(dev)
    counts = torch.empty((n_frames, s, s), dtype=torch.float32, device=dev)
    for f in range(n_frames):
        counts[f] = pair_engine.frame_cn_counts(pos[f], cells_t[f], sp, cut,
                                                s, chunk, inv_cell=inv[f])
    full = cn.cn_table(counts.cpu().numpy(), species, unique, z_to_idx,
                       CUTOFFS, steps)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0

    before = tracing.snapshot()
    t0 = time.perf_counter()
    windowed = cn.cn_columns(sub, CUTOFFS, steps, device=dev)
    torch.cuda.synchronize()
    t_win = time.perf_counter() - t0
    got = tracing.diff(tracing.snapshot(), before)["counts"]
    counters = {k: got.get(k, 0)
                for k in ("cn.frames", "cn.frames_windowed", "cn.frames_full")}
    for key, col in full.items():
        check(np.array_equal(windowed[key], col),
              f"cn column {key}: cn_columns != full pass")
    check(counters["cn.frames"] == n_frames, f"cn counters {counters}")
    say(f"cn passes ({n_frames} frames): full pass (frame_cn_counts) "
        f"{t_full:.3f} s = {1e3 * t_full / n_frames:.2f} ms/frame; "
        f"cn.cn_columns (windowed, kernel #4 at K "
        f"{pair_engine.CN_WINDOW_SLOTS}, chunk {chunk}, W {window}) "
        f"{t_win:.3f} s = {1e3 * t_win / n_frames:.2f} ms/frame; counters "
        f"{counters}; columns equal on {card}")
    return {"full_s": t_full, "windowed_s": t_win, "frames": n_frames,
            "counters": counters, "chunk": chunk, "window": window}


def entry_cpu_parity(dev, n_atoms=2048):
    """Phase 5, entry points: a 2048-atom excerpt on the card and on the
    CPU (plain versions). RDF, both CNs exact; BAD and BadByCn counts with
    exact totals and at most one-bin angle moves; MSD to rtol 1e-4 (8
    frames: two frames give only MSD(0))."""
    import numpy as np
    import torch

    from amof_tpu_torch import bad, cn, msd, rdf

    t0 = time.perf_counter()
    small, _ = make_trajectory(8, n_atoms, seed=3)
    two = excerpt(small, 2)
    window, time_fs = msd.msd_windows(8, delta_time=1)
    x = small.positions.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    atol = 8 * 2.0**-23 * float((x ** 2).sum(axis=-1).mean())
    out = []
    for d in (dev, torch.device("cpu")):
        out.append({
            "rdf": rdf.rdf_columns(two, BENCH["dr"], device=d),
            "rdf_cn": rdf.rdf_cn_columns(two, CUTOFFS, two.step, device=d),
            "cn": cn.cn_columns(two, CUTOFFS, two.step, device=d),
            "bad": bad._compute_counts(two, CUTOFFS, BENCH["dtheta"],
                                       device=d),
            "bad_by_cn": bad._compute_counts(two, CUTOFFS, BENCH["dtheta"],
                                             by_cn=True, device=d),
            "window_msd": msd.msd_columns(small, window, time_fs, device=d),
            "direct_msd": msd.direct_msd_columns(small, small.step,
                                                 device=d),
        })
    gpu, cpu = out
    for name in ("rdf", "rdf_cn", "cn"):
        check(list(gpu[name]) == list(cpu[name]), f"{name}: columns differ")
        for key in gpu[name]:
            check(np.array_equal(gpu[name][key], cpu[name][key]),
                  f"{name} column {key}: card != CPU")
    moved = 0.0
    for name in ("bad", "bad_by_cn"):
        (gc, gn, _), (cc, cnames, _) = gpu[name], cpu[name]
        check(gn == cnames and gc.shape == cc.shape,
              f"{name}: specs or shapes differ ({gc.shape} vs {cc.shape})")
        check(bins_within_one(gc, cc),
              f"{name}: card vs CPU beyond one-bin moves")
        moved += float(np.abs(gc - cc).sum())
    for name in ("window_msd", "direct_msd"):
        for key in gpu[name]:
            check(np.allclose(gpu[name][key], cpu[name][key], rtol=1e-4,
                              atol=atol),
                  f"{name} column {key}: card vs CPU beyond rtol 1e-4")
    say(f"entry points card == CPU plain on a {n_atoms}-atom excerpt: RDF, "
        f"RDF-integral CN and CN columns exact; BAD and BadByCn totals exact,"
        f" {moved:.0f} angle-bin differences; WindowMsd and DirectMsd within"
        f" rtol 1e-4 ({time.perf_counter() - t0:.1f} s)")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False (needs one CUDA card)")
        return 2
    try:
        from amof_tpu_torch import _build
        from amof_tpu_torch.parallel.pipeline import FusedAnalysis
    except ImportError as exc:
        say(f"FAIL: the port is not importable here ({exc})")
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    card = smi[0].strip()
    print(card, flush=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; device "
        f"{torch.cuda.get_device_name(0)}")

    # 2. kernel build, through the warmup (kernel #9) in this cold
    # process; then cold-start children
    wlaunch = warmup_phase(card)
    log = _build.BUILD_DIR / "ptxas.log"
    if log.exists():
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
            fh.write(log.read_text())
        for line in log.read_text().splitlines():
            if "Used" in line:
                say(f"ptxas: {line.strip()}")
    cold = cold_start(card)
    ring_build = ring_engine_build(card)

    # the workload
    t0 = time.perf_counter()
    batch, box = make_trajectory(256, 10240)
    say(f"trajectory: {batch.num_frames} frames x {batch.num_atoms} atoms, "
        f"box {box:.2f} A ({time.perf_counter() - t0:.1f} s)")
    fa = FusedAnalysis(CUTOFFS, **BENCH)
    step_fn, args, meta = fa.prepare(batch, device=dev)
    say(f"layout: {meta['n_atoms_padded']} atom slots (species-blocked "
        f"{meta['blocked']}), bins {meta['bins']}, window "
        f"{meta['bad_window']}, ortho {meta['ortho']}")

    # 3. kernels vs plain
    checks, fextras, table_counts = kernel_checks(args, meta, batch, dev,
                                                  card)
    work = fused_work(args, meta, batch, table_counts)
    fextras["window_table_slab"]["bound_ms_all_columns"] = bound(
        work["window_table_slab"][0],
        35 * 3 * meta["bad_slab"].window * batch.num_atoms)[0]
    fextras["window_table"]["bound_ms_all_columns"] = bound(
        work["window_table"][0],
        35 * table_counts["window_table"]["width"]
        * args.positions.shape[1])[0]
    geometry = rdf_geometry(args.positions.shape[1],
                            -(-batch.num_atoms // BENCH["chunk"])
                            * BENCH["chunk"], len(meta["unique"]),
                            meta["bins"], meta["ortho"])
    del step_fn, args
    from amof_tpu_torch.pore import BatchedPore

    pb = pore_batch_of(batch, PORE_FRAMES)
    _, _, pmeta = BatchedPore(**PORE).prepare(pb, device=dev)
    say(f"pore plan: grid {pmeta['grid']}, masks {pmeta['col_plan']}, "
        f"surface {pmeta['surf_plan']}, K {pmeta['k']}")
    pchecks, pwork, pextras = pore_kernel_checks(
        pb, pore_batch_of(batch, 1, squeeze=0.72), pmeta, dev, card)
    checks.update(pchecks)
    work.update(pwork)
    (checks["warmup_copy"], clone_ms, copy_ms, host_us,
     work["warmup_copy"]) = warmup_kernel_check(dev, card)

    # 4. the main path, counted on its own
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, meta = fa.run(batch, device=dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read_launches()
    moved = read_counts()
    say(f"main path launches: {launches}")
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    # every frame's first pass launches #1 once, as a graph replay too,
    # and a capture's eager pass once more (as the card test
    # test_replays_count_frames_and_launches in
    # tests/test_torch_fused_graph.py holds on the bench glass)
    captures = moved.get("pipeline.graph_captures", 0)
    check(launches["rdf_counts_blocked"] == batch.num_frames + captures,
          f"main path: {launches['rdf_counts_blocked']} launches of "
          f"rdf_counts_blocked for {batch.num_frames} frames and "
          f"{captures} captures")
    if meta["bad_slab"] is not None:
        check(moved.get("pipeline.frames_graphed", 0) == batch.num_frames,
              "main path: not every frame replayed its graph")
    check_outputs(out, meta, batch.num_frames)
    say(f"fused first run (prepare + step, cold): {first:.2f} s")

    # side runs, counted apart: a crowded frame, and a cell too small for
    # the species-blocked layout (the one place kernel #2 runs)
    crowded = crowd_one_zn(batch._replace(
        positions=batch.positions[:4], cell=batch.cell[:4],
        step=batch.step[:4]), 2, box)
    small, _ = make_trajectory(16, 272, seed=1)
    reset_launches()
    out_c, _ = FusedAnalysis(CUTOFFS, **{**BENCH, "frames_per_call": 4}).run(
        crowded, device=dev)
    out_s, meta_s = FusedAnalysis(CUTOFFS, **{**BENCH, "chunk": 64}).run(
        small, device=dev)
    torch.cuda.synchronize()
    side = read_launches()
    say(f"side-run launches: {side}")
    check(not meta_s["blocked"], "272-atom cell should not be blocked")
    check(side["rdf_counts"] > 0, "kernel rdf_counts not launched")
    check(side["window_table"] > 0, "crowded frame did not rerun")
    check_outputs(out_c, meta, 4)

    # 4, pore: the batched pore step, counted on its own, and a void-slab
    # side run counted apart
    _, _, plaunch = pore_main(pb, dev)
    pside = pore_side_run(batch, dev)

    # 4, per-frame pore: each call of the per-frame path and of
    # BatchedPore's distance-field plans counted on its own
    per_frame = per_frame_phase(batch, dev, card)

    # 4, entry points: each analysis on its own, counted on its own
    entry_launches, entry_walls = entry_points(batch, box, pb, out, meta,
                                               dev, card)
    cn_times = cn_passes(batch, dev, card)

    # 4, trajectory I/O and ring statistics, each run counted on its own
    io_rows = io_phase(batch, dev, card)
    ring_out = ring_phase(dev, card)

    # 5. correctness against the plain path on the CPU
    cpu_parity(batch)
    pore_cpu_parity(dev)
    per_frame_cpu_parity(dev)
    entry_cpu_parity(dev)
    ring_cpu_parity(dev)

    # 6. times
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        step_fn, args, meta = fa.prepare(batch, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs.append((t1 - t0, t2 - t1))
        del step_fn, args
    prep, step = min(r[0] for r in runs), min(r[1] for r in runs)
    fps = batch.num_frames / step
    say(f"fused step: {step:.3f} s for {batch.num_frames} frames = "
        f"{fps:.1f} frames/s ({1e3 * step / batch.num_frames:.2f} ms/frame; "
        f"prepare {prep:.2f} s; runs {runs}) on {card}")
    for name, (err, ms, pms) in checks.items():
        say(f"time {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms "
            f"({pms / ms:.1f}x) on {card}")
    profile_step(batch, dev)

    # 6 and 7, pore: step time, prepare time, stage split
    pore_ms, pore_prep, pore_miss = pore_times(pb, dev, card)

    # 7. split by the port's spans
    registry_split(fa, batch, dev)

    kernels = []
    for name, src, replaces in KERNELS:
        err, ms, pms = checks[name]
        pore = name in PORE_PATH
        path = (wlaunch if name == "warmup_copy" else plaunch if pore
                else launches)
        bound_ms, bound_by = bound(*work[name])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": path[name],
                        "on_main_path": (name in MAIN_PATH or pore
                                         or name == "warmup_copy"),
                        "side_launches": (pside if pore else side)[name],
                        "entry_point_launches": {
                            e: n[name] for e, n in entry_launches.items()
                            if name in n},
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": (clone_ms if name == "warmup_copy"
                                       else None)})
        if name == "warmup_copy":
            kernels[-1]["copy_ms"] = copy_ms
        if name == "flood_fill":
            kernels[-1]["per_frame_launches"] = {
                r["call"]: r["flood_fill_launches"] for r in per_frame}
        kernels[-1].update(pextras.get(name, fextras.get(name, {})))
        if name in geometry:
            kernels[-1]["geometry"] = geometry[name]
        every = kernels[-1].get("bound_ms_all_columns")
        say(f"bound {name}: {bound_ms:.4f} ms ({bound_by}; "
            f"{work[name][0]:.3e} B, {work[name][1]:.3e} f32 ops"
            + ("" if every is None else f"; all columns {every:.4f} ms")
            + f") vs kernel {ms:.3f} ms on {card}")
    print(json.dumps({"kernels": kernels, "fused_frames_per_s": fps,
                      "pore_ms_per_frame": pore_ms,
                      "pore_prepare_s": pore_prep,
                      "pore_first_pass_misses": pore_miss,
                      "entry_point_s": entry_walls, "cn_passes": cn_times,
                      "per_frame_pore": per_frame,
                      "cold_start": cold,
                      "io": io_rows, "ring": ring_out,
                      "ring_engine": ring_build,
                      "launch_path_us": host_us, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cold_start_pairs():
    """``--cold-start-pairs``: the card, then the cold-start children with
    the fused pairs; prints their rows as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False (needs one CUDA card)")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(json.dumps({"cold_start": cold_start(card, pairs=True),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start"]:
        cold_start_child(sys.argv[2])
        sys.exit(0)
    try:
        code = (cold_start_pairs() if sys.argv[1:2] == ["--cold-start-pairs"]
                else main())
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        code = 1
    sys.exit(code)
