#!/usr/bin/env python3
"""The benchmark of amof_tpu_torch (the PyTorch and CUDA port): one run of
one cell of ``BENCHMARK.json``.

    python3 bench_torch/run.py --workload glass9792.fused --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for. Without a CUDA card (or with fewer than the cell's ``chips``) it
exits 2 and prints no result: it never falls back to the CPU. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``host``: the CPU model and the clock of the one core
the run is pinned to; ``checks`` last: every number compared with the
plain reference beside its limit, also printed as the last lines of
standard error). ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from ``torch.profiler`` over units run after the
window (and the window's host rate).

Lookup by name (``harness.py`` holds the engine). A workload entry of
``BENCHMARK.json`` names a configuration and a traffic mix:

  configs/<file>.json       the configuration's ``file``: the deployment
                            (elements with counts, masses and radii, the
                            cell, cutoffs, binning, the bonded network
                            and its thermal motion: ``network.py``)
  traffic/<traffic>.json    the mix: ``kind`` (a module of ``kinds/``),
                            frames a piece, pieces, the program's
                            arguments, units to check and to trace
  limits/<workload>.json    the limit of each number ``correct`` compares
  metrics/<metric>.py       per-layer metric: ``read(trace)`` returns a
                            number or None (nothing to read: left out)
  work/<kernel>.py          a kernel's operations and bytes from a unit's
                            inputs and outputs, and its kernel names
  kinds/<kind>.py           the mix's ``kind``: ``Runner(config, traffic,
                            device).unit(piece)`` drives the program;
                            ``reference`` (plain PyTorch,
                            ``reference/<kind>.py``), ``compare``, and
                            ``REHEARSAL_FRAMES`` (frames a piece at
                            ``rehearse.py``'s size)

To add a configuration: a file under ``configs/`` and an entry under
``configs`` in ``BENCHMARK.json``. A mix of an existing kind: a file under
``traffic/``. A new kind: ``kinds/<kind>.py`` and ``reference/<kind>.py``
beside its mix. A cell: an entry under ``workloads``, its
``limits/<workload>.json`` (limits set from readings, see PERF.md), and its
name appended to the ``workloads`` of the end-to-end metric it reports
(``analysis_frames_per_s`` for a cell of per-analysis entry points): that
list is the one existing line a new cell edits. A per-layer metric:
``metrics/<name>.py`` and an entry under ``per_layer``. ``run_cell`` reads
an end-to-end metric by its unit and source: ``frames/s`` on the host
clock (all the window's frames over its seconds), ``us/frame`` from the
device trace (the device's busy time over the window's frames), and
``setup_s``.

Caches: the program builds its kernels into ``amof_tpu_torch/_build/``
inside the checkout (keyed by a hash of the sources, so only the first
run of a checkout builds); PyTorch's extension and Triton caches are
pointed inside the checkout too. ``BENCH_RUN`` is not read. The
benchmark imports neither jax nor the JAX package, and a run that finds
either loaded once its window has closed exits 3 with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
# one process, few threads: the host loop is the bottleneck, and thread
# pools spinning beside it on shared cores widen the runs' spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))
# JAX and the JAX package, by whole top-level module name: none may be
# loaded in the process once the window has closed
NOT_LOADED = {"jax", "jaxlib", "flax", "amof_tpu"}


def pin_to_one_core():
    """Pins this process, and every thread it starts from here on, to the
    last core it may use, so that no run is moved between cores; called
    before torch is imported and starts its threads. Returns the core."""
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    return core


def host_info(core):
    """The host's CPU model and the pinned core's clock now (MHz), from
    /proc/cpuinfo (None where it does not say)."""
    model, mhz, cur = None, None, None
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                key, val = key.strip(), val.strip()
                if key == "processor":
                    cur = int(val)
                elif key == "model name" and model is None:
                    model = val
                elif key == "cpu MHz" and cur == core:
                    mhz = float(val)
    except OSError:
        pass
    return {"cpu": model, "core": core, "mhz": mhz}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core = pin_to_one_core()
    host_start = host_info(core)

    from bench_torch import harness

    bench = harness.Bench(ROOT)
    cell = bench.workload(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("run.py: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = sorted({m.partition(".")[0] for m in sys.modules} & NOT_LOADED)
    if found:
        print(f"run.py: the run loaded {', '.join(found)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["host"] = dict(host_start, mhz_end=host_info(core)["mhz"])
    result["checks"] = checks
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
