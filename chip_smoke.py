#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (amof_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line(s) of standard output:

  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. kernel build: ``amof_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
  3. each hand-written kernel against its plain PyTorch version on the
     card, at the shapes of bench.py's fused step (10240-atom ZIF-glass
     trajectory, dr 0.01 A, K 8; kernel #4 at K 16, chunk 256, W 1408):
     integer outputs must be equal, and so must the neighbour positions;
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
  7. stage split: the main path once more with a synchronize around each
     stage (host ms per frame; the table goes to chiprun_out/).

The second-to-last line is a JSON object describing the kernels; the last
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
]


# kernels that bench.py's configuration launches; rdf_counts (#2) runs
# only where the species-blocked layout would pad past 1.5x
MAIN_PATH = ("rdf_counts_blocked", "window_table_slab", "window_table")


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


def crowd_one_zn(batch, frame, box, seed=5):
    """Copy of ``batch`` whose ``frame`` has twelve N atoms within 1.7 A
    of the first Zn: that Zn then has more than 8 neighbours."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = batch.positions.copy()
    n_zn = int((batch.species == 30).sum())
    off = rng.normal(0, 1, (12, 3))
    off *= (rng.uniform(1.0, 1.7, 12) / np.linalg.norm(off, axis=1))[:, None]
    pos[frame, n_zn:n_zn + 12] = (pos[frame, 0] + off) % box
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


def max_abs_err(got, ref):
    err = 0.0
    for g, r in zip(got, ref):
        err = max(err, float((g.double() - r.double()).abs().max()))
    return err


def kernel_checks(args, meta, batch, dev, frames=(0, 1, 2),
                  window_check=(16, 256, 1408)):
    """Phase 3: every kernel vs its plain version at the main path's
    shapes. Returns {name: (max_abs_err, ms, plain_ms)}."""
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
    return res


def reset_launches():
    from amof_tpu_torch.ops import neighbor_kernel, rdf_kernel

    for d in (rdf_kernel.LAUNCHES, neighbor_kernel.LAUNCHES):
        for key in d:
            d[key] = 0


def read_launches():
    from amof_tpu_torch.ops import neighbor_kernel, rdf_kernel

    return {**rdf_kernel.LAUNCHES, **neighbor_kernel.LAUNCHES}


# stages of the fused step timed by stage_split: (module, attribute, label);
# "frame pass" contains the stages below it except MSD
STAGES = [
    ("amof_tpu_torch.parallel.pipeline", "_frame_pass", "frame pass (all)"),
    ("amof_tpu_torch.ops.pair_engine", "frame_rdf_counts", "RDF (#1)"),
    ("amof_tpu_torch.ops.slab_table", "build_slab_layout", "slab layout"),
    ("amof_tpu_torch.ops.neighbor_kernel", "window_table_slab",
     "slab table (#3)"),
    ("amof_tpu_torch.ops.neighbor_kernel", "window_table",
     "window table (#4)"),
    ("amof_tpu_torch.ops.slab_table", "cn_from_table", "CN from the table"),
    ("amof_tpu_torch.ops.bad_kernel", "angle_histograms", "angle histograms"),
    ("amof_tpu_torch.parallel.pipeline", "_msd", "MSD"),
]


def stage_split(fa, batch, dev):
    """Phase 7: host ms/frame of each stage of one fused run, each call
    bracketed by torch.cuda.synchronize() (which inflates the total)."""
    import importlib

    import torch

    spent = {label: 0.0 for _, _, label in STAGES}
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

    for mod_name, attr, label in STAGES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), label))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = fa.run(batch, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    check(not out["bad_overflow"].any(), "stage split: frames left flagged")
    n = batch.num_frames
    lines = [f"stage split, {n} frames, synced stages: wall {wall:.3f} s = "
             f"{1e3 * wall / n:.3f} ms/frame"]
    lines += [f"  {label:<20s} {1e3 * spent[label] / n:8.3f} ms/frame  "
              f"calls {calls[label]}" for _, _, label in STAGES]
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


def profile_step(batch, dev, n_frames=16):
    """Device time by kernel name over a short fused run (torch.profiler);
    the full table goes to OUT_DIR."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from amof_tpu_torch.parallel.pipeline import FusedAnalysis

    sub = batch._replace(positions=batch.positions[:n_frames],
                         cell=batch.cell[:n_frames],
                         step=batch.step[:n_frames])
    kw = {k: v for k, v in BENCH.items() if k != "frames_per_call"}
    step_fn, args, _ = FusedAnalysis(CUTOFFS, with_msd=False, **kw).prepare(
        sub, device=dev)
    step_fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as fh:
        fh.write(table)
    # device-side events only (kernels, memcpy, memset): the aten rows
    # repeat their kernels' time as "self CUDA"
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not evs:
        say("profile: the profiler reported no device events (busy share "
            "not measured)")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3  # ms
    share = busy / (wall * 1e3)
    say(f"profile ({n_frames} frames, no MSD): wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * share:.0f}%), idle "
        f"{100 * (1 - share):.0f}%")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        say(f"  {e.self_device_time_total / 1e3 / n_frames:8.3f} ms/frame "
            f"{e.count / n_frames:6.1f}/frame  {e.key[:70]}")


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

    # 2. kernel build
    t0 = time.perf_counter()
    _build.library()
    how = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds
           else "already built from these sources")
    say(f"build: {time.perf_counter() - t0:.1f} s ({how}) -> "
        f"{_build.library_path().name}")
    log = _build.BUILD_DIR / "ptxas.log"
    if log.exists():
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
            fh.write(log.read_text())
        for line in log.read_text().splitlines():
            if "Used" in line:
                say(f"ptxas: {line.strip()}")

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
    checks = kernel_checks(args, meta, batch, dev)
    del step_fn, args

    # 4. the main path, counted on its own
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, meta = fa.run(batch, device=dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = read_launches()
    say(f"main path launches: {launches}")
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
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

    # 5. correctness against the plain path on the CPU
    cpu_parity(batch)

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

    # 7. stage split
    stage_split(fa, batch, dev)

    kernels = []
    for name, src, replaces in KERNELS:
        err, ms, pms = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "on_main_path": name in MAIN_PATH,
                        "side_launches": side[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels, "fused_frames_per_s": fps,
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as exc:
        say(f"FAIL: {exc}")
        code = 1
    sys.exit(code)
