"""The benchmark's engine: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by name (see ``run.py``'s header):

  configs/<config>.json     the deployment (elements, cell, cutoffs, ...)
  traffic/<traffic>.json    the mix: its ``kind`` names the module in
                            ``kinds/`` that drives the program and holds
                            the reference (``reference/<kind>.py``), the
                            comparison and the rehearsal size; the rest
                            are its parameters
  limits/<workload>.json    the limit of each number ``correct`` compares
  metrics/<metric>.py       ``read(trace) -> float | None`` per metric
  work/<kernel>.py          a kernel's operations and bytes (rooflines)

A run: make the cell's pieces from the seed on the device, build the
program's runner, run one warm-up unit (set-up ends there), then run
whole units back to back until ``seconds`` have passed (a closed loop;
under ``DeviceWindow`` where the cell has a device-trace end-to-end
metric), with ``--trace 1`` then the traced units under the profiler,
read the peak memory, free the program, and compare a sample of the
window's units, drawn from the seed, with the plain reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import pathlib
import random
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_file_module(path, name):
    """A module from a file whose name need not be an identifier
    (``metrics/device_idle_pct.fused.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def _for(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"] if self._for(m, cell)]

    def per_layer(self, cell):
        return [m for m in self.spec["per_layer"] if self._for(m, cell)]


def load_traffic(cell):
    return load_json(HERE / "traffic" / f"{cell['traffic']}.json")


def kind_module(traffic):
    return importlib.import_module(f"bench_torch.kinds.{traffic['kind']}")


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


SPAN_NAMES = set()


def span(name):
    """A benchmark span: a ``torch.profiler`` range, free when no
    profiler runs. The profiler mirrors each range on the device's
    timeline; ``TraceData`` leaves those out of the device's activity."""
    import torch

    SPAN_NAMES.add(name)
    return torch.profiler.record_function(name)


# --------------------------------------------------------------------------
# Inputs from the seed
# --------------------------------------------------------------------------

def species_of(config):
    """Atomic numbers of the atoms in generation order (the elements in
    the order the configuration lists them, each as one block)."""
    import numpy as np

    return np.concatenate([np.full(e["count"], e["Z"], np.int32)
                           for e in config["elements"].values()])


def frames_per_piece(config, traffic):
    return traffic["frames_per_piece"] or config["trajectory_frames"]


def make_pieces(config, traffic, seed, device):
    """The cell's distinct trajectory pieces, drawn on ``device`` from one
    generator seeded with ``seed``: each the configuration's bonded
    Zn(Im)2 network with its own ring angles, shift and thermal motion
    (``network.py``). Returned as host arrays, as a user's trajectory
    arrives: dicts of positions f32 [F, N, 3], cell f32 [F, 3, 3],
    species i32 [N], step i32 [F]."""
    import numpy as np
    import torch

    from bench_torch import network

    geo = network.sites(config)
    network.check_counts(config, len(geo["zn"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f = int(frames_per_piece(config, traffic))
    species = species_of(config)
    cell = np.tile(np.diag(np.asarray(config["cell_A"], np.float32)),
                   (f, 1, 1))
    pieces = []
    for _ in range(int(traffic["pieces"])):
        pos = network.trajectory(config, geo, f, gen, device)
        pieces.append({"positions": pos.cpu().numpy(), "cell": cell,
                       "species": species,
                       "step": np.arange(f, dtype=np.int32)})
    return pieces


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------

class Unit:
    """One finished unit of the window."""

    def __init__(self, piece, frames, seconds, out):
        self.piece, self.frames, self.seconds, self.out = (
            piece, frames, seconds, out)


def run_cell(bench, cell, seed, seconds, trace, device, t_start,
             wrap_runner=None, config=None, traffic=None):
    """One run of ``cell`` (a workload entry). Returns the result dict of
    the contract's last line (``checks`` last). ``wrap_runner`` lets a
    test plant a fault between the harness and the program; ``config``
    and ``traffic`` replace the cell's (a rehearsal at a small size)."""
    import torch

    config = config or bench.config(cell["config"])
    traffic = traffic or load_traffic(cell)
    limits = load_json(HERE / "limits" / f"{cell['name']}.json")
    kind = kind_module(traffic)

    pieces = make_pieces(config, traffic, seed, device)
    runner = kind.Runner(config, traffic, device)
    if wrap_runner is not None:
        runner = wrap_runner(runner)
    with span("bench.warmup"):
        runner.unit(pieces[0])
    sync(device)
    setup_s = time.perf_counter() - t_start

    units = []
    # a device-trace end-to-end metric: the profiler's device activity
    # over the whole window, and no host events
    window_trace = (DeviceWindow(device) if not trace and any(
        m["source"] == "device_trace"
        for m in bench.end_to_end(cell["name"])) else None)
    t0 = time.perf_counter()
    while True:
        i = len(units) % len(pieces)
        u0 = time.perf_counter()
        with span("bench.unit"):
            out = runner.unit(pieces[i])
        sync(device)
        u1 = time.perf_counter()
        units.append(Unit(i, len(pieces[i]["step"]), u1 - u0, out))
        if u1 - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    device_busy_s = window_trace.stop() if window_trace else None

    # the traced units run after the window, so that the window's host
    # rate is the same as without the trace
    traced, prof = [], None
    if trace:
        prof = _start_profiler()
        for k in range(int(traffic["trace_units"])):
            i = (len(units) + k) % len(pieces)
            u0 = time.perf_counter()
            with span("bench.unit"):
                out = runner.unit(pieces[i])
            sync(device)
            traced.append(Unit(i, len(pieces[i]["step"]),
                               time.perf_counter() - u0, out))
        prof.__exit__(None, None, None)

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    del runner
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the reference on a sample of the window's units, drawn from the seed
    rng = random.Random(int(seed))
    n_check = min(int(traffic["check_units"]), len(units))
    checked = sorted(rng.sample(range(len(units)), n_check))
    checks, failed = {}, 0
    t_ref = time.perf_counter()
    for j in checked:
        u = units[j]
        ref = kind.reference(config, traffic, pieces[u.piece], device)
        numbers = kind.compare(u.out, ref, config, traffic)
        unit_ok = True
        for name, value in numbers.items():
            limit = float(limits[name])
            ok = math.isfinite(value) and value <= limit
            unit_ok &= ok
            prev = checks.get(name)
            if prev is None or not (value <= prev["value"]):
                checks[name] = {"value": value, "limit": limit}
        failed += 0 if unit_ok else 1
        del ref
    reference_s = time.perf_counter() - t_ref
    missing = set(limits) - set(checks)
    correct = failed == 0 and not missing

    frames = sum(u.frames for u in units)
    result = {"correct": correct, "attempted": len(units), "failed": failed}
    dev_info = device_info(device, memory_peak)
    if trace:
        tr = TraceData(prof, traced, pieces, config, traffic, device,
                       window=(frames, window_s))
        result["metrics"] = {}
        for m in bench.per_layer(cell["name"]):
            reader = load_file_module(HERE / "metrics" / f"{m['name']}.py",
                                      f"bench_metric_{m['name']}")
            value = reader.read(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        result["metrics"] = {}
        for m in bench.end_to_end(cell["name"]):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["unit"] == "frames/s" and m["source"] == "host_clock":
                value = frames / window_s
            elif m["unit"] == "us/frame" and m["source"] == "device_trace":
                if device_busy_s is None:
                    continue  # no card: nothing to read
                value = 1e6 * device_busy_s / frames
            else:
                raise SystemExit(f"no reading for metric {m['name']!r}")
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    result["device"] = dev_info
    result["window"] = {"frames": frames, "seconds": window_s,
                        "device_busy_s": device_busy_s}
    result["units"] = [[u.piece, u.frames, u.seconds] for u in units]
    result["reference_s"] = reference_s
    result["checks"] = checks
    for name in missing:
        checks[name] = {"value": None, "limit": limits[name]}
    return result


def device_info(device, memory_peak):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(memory_peak)}


def print_result(result, out=sys.stdout, err=sys.stderr):
    """The contract's output: every compared number beside its limit as
    the last lines on standard error, the result as the last line of
    standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


# --------------------------------------------------------------------------
# The traced run
# --------------------------------------------------------------------------

def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


class DeviceWindow:
    """The device's busy time over a whole timed window: the profiler with
    the device's activity alone (no host operations recorded, so the host
    loop runs nearly as without it), read from its raw results. Building
    the profiler's event tree would take minutes for the ~10^6 kernels of
    a window. Off a card it records nothing and reads None."""

    def __init__(self, device):
        import torch

        self.prof = None
        if torch.device(device).type == "cuda":
            self.prof = torch.autograd.profiler.profile(
                use_device="cuda", use_kineto=True, use_cpu=False)
            self.prof.__enter__()

    def stop(self):
        """Seconds in which a device activity ran, or None."""
        if self.prof is None:
            return None
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        events = torch._C._autograd._disable_profiler().events()
        self.prof = None
        spans = []
        for e in events:
            annotation = getattr(e, "is_user_annotation", None)
            if (e.device_type() == DeviceType.CUDA
                    and not (annotation and annotation())):
                start = e.start_ns()
                spans.append((start, start + e.duration_ns()))
        del events
        if not spans:
            return None
        lo = min(s for s, _ in spans)
        hi = max(e for _, e in spans)
        return sum(e - s for s, e in _union(spans, lo, hi)) / 1e9


NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
NAME_CHARS = 160  # of a kernel's name in the breakdown


class TraceData:
    """What the per-layer readers read: the profiled units (their pieces
    and outputs), device intervals, host spans, in microseconds of the
    profiler's clock."""

    def __init__(self, prof, units, pieces, config, traffic, device,
                 window=(0, 0.0)):
        from torch.autograd import DeviceType

        self.units, self.pieces = units, pieces
        # the untraced window's frames and seconds (its host rate)
        self.window_frames, self.window_seconds = window
        self.config, self.traffic, self.device = config, traffic, device
        self.frames = sum(u.frames for u in units)
        self.device_events, self.host_events = [], []
        for e in (prof.events() if prof is not None else []):
            rng = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if (e.name not in SPAN_NAMES
                        and not getattr(e, "is_user_annotation", False)):
                    self.device_events.append(rng)
            elif e.device_type == DeviceType.CPU:
                self.host_events.append(rng)
        spans = self.spans("bench.unit")
        if spans:
            self.t0 = min(s for s, _ in spans)
            self.t1 = max(e for _, e in spans)
        else:
            self.t0 = self.t1 = 0.0
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy = _union([(s, e) for _, s, e in self.device_events],
                           self.t0, self.t1)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def spans(self, name):
        return [(s, e) for n, s, e in self.host_events if n == name]

    def kernels(self):
        return [ev for ev in self.device_events
                if not ev[0].startswith(NOT_KERNELS)]

    def device_seconds(self, patterns):
        """Device seconds of the kernels whose name holds one of
        ``patterns``, or None where the trace holds none."""
        hits = [e - s for n, s, e in self.device_events
                if any(p in n for p in patterns)]
        return sum(hits) / 1e6 if hits else None

    def roofline_pct(self, kernel):
        """100 x the bound time of the traced units' work for ``kernel``
        (``work/<kernel>.py``) over its kernels' device time; None where
        the trace holds none of them or the work cannot be counted."""
        from bench_torch.work import peaks

        mod = load_file_module(HERE / "work" / f"{kernel}.py",
                               f"bench_work_{kernel}")
        dev_s = self.device_seconds(mod.KERNELS)
        if dev_s is None or not self.units:
            return None
        bound = 0.0
        for u in self.units:
            w = mod.work(u.out, self.pieces[u.piece], self.config,
                         self.traffic, self.device)
            if w is None:
                return None
            bound += peaks.bound_seconds(*w)
        return 100.0 * bound / dev_s

    def idle_pct(self):
        if self.window_s <= 0 or not self.device_events:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels_per_frame(self):
        if not self.frames or not self.device_events:
            return None
        return len(self.kernels()) / self.frames

    def breakdown(self):
        """The device operations that took most time, and the idle time
        between device activity summed by what the host was doing (the
        benchmark span and the innermost host event at each gap)."""
        by_name = {}
        for n, s, e in self.device_events:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, prev = [], self.t0
        for s, e in self.busy + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        mids = [(a + b) / 2 for a, b in gaps]
        inner = _innermost(self.host_events, mids)
        outer = _innermost([h for h in self.host_events
                            if h[0] in SPAN_NAMES], mids)
        idle = {}
        for (a, b), i, o in zip(gaps, inner, outer):
            label = (f"{o or '-'} / {i[:NAME_CHARS]}" if i
                     else "host: no event")
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in top]}


def _innermost(events, times):
    """For each of the ascending ``times``, the name of the latest-started
    event (name, start, end) still running then, or None: one sweep with
    a heap keyed by start."""
    import heapq

    events = sorted(events, key=lambda ev: ev[1])
    heap, out, k = [], [], 0
    for t in times:
        while k < len(events) and events[k][1] <= t:
            heapq.heappush(heap, (-events[k][1], k))
            k += 1
        while heap and events[heap[0][1]][2] < t:
            heapq.heappop(heap)
        out.append(events[heap[0][1]][0] if heap else None)
    return out


def _union(intervals, lo, hi):
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
