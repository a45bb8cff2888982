#!/usr/bin/env python3
"""Rehearse every cell of ``BENCHMARK.json`` on the CPU at a small size,
with the program's plain PyTorch versions (``device="cpu"``): the
pieces, the window loop, the reference, the comparison, the traced run
and the result line, before any card time is spent. ``run.py`` itself
refuses to run without a card.

    python3 bench_torch/rehearse.py [--workload NAME] [--seed N]

Small size: the configuration's network on at most 2 x 2 x 1 node
cells (``small``) and few frames (the kind's ``REHEARSAL_FRAMES``); two
pieces a cell. The CPU's numbers are no device metrics: device readers
find nothing there.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402


def small(config, traffic):
    """Copies of ``config`` and ``traffic`` at the rehearsal size: the
    network at most 2 x 2 x 1 node cells (1088 atoms), the same density,
    elements and widths (bonds, cutoffs, binning, radii); few frames."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    net = config["network"]
    cut = [min(r, k) for r, k in zip(net["repeats"], (2, 2, 1))]
    config["cell_A"] = [c / r * k for c, r, k in
                        zip(config["cell_A"], net["repeats"], cut)]
    zn = config["elements"]["Zn"]["count"] // int(
        net["repeats"][0] * net["repeats"][1] * net["repeats"][2]) * (
        cut[0] * cut[1] * cut[2])
    net["repeats"] = cut
    for el, per_zn in (("Zn", 1), ("N", 4), ("C", 6), ("H", 6)):
        config["elements"][el]["count"] = per_zn * zn
    config["atoms"] = 17 * zn
    f = harness.kind_module(traffic).REHEARSAL_FRAMES * (2 if zn < 64 else 1)
    traffic["frames_per_piece"] = f
    config["trajectory_frames"] = f
    traffic["pieces"] = 2
    traffic["trace_units"] = 1
    return config, traffic


def rehearse(bench, cell, seed, trace):
    config, traffic = small(bench.config(cell["config"]),
                            harness.load_traffic(cell))
    t0 = time.perf_counter()
    res = harness.run_cell(bench, cell, seed, 0.5, trace, "cpu", t0,
                           config=config, traffic=traffic)
    print(f"rehearse {cell['name']} trace={int(trace)}: "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    harness.print_result(res)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**32 + 17)
    args = ap.parse_args(argv)
    bench = harness.Bench(ROOT)
    cells = [bench.workload(args.workload)] if args.workload else \
        bench.spec["workloads"]
    bad = []
    for cell in cells:
        for trace in (False, True):
            res = rehearse(bench, cell, args.seed, trace)
            # a device-trace end-to-end metric has nothing to read here
            want = {m["name"] for m in (bench.per_layer(cell["name"]) if trace
                    else bench.end_to_end(cell["name"]))
                    if trace or m["source"] != "device_trace"}
            host_only = {m["name"] for m in bench.per_layer(cell["name"])
                         if m["source"] == "host_clock"}
            got = set(res["metrics"])
            if not res["correct"] or not got <= want or (
                    not trace and got != want) or (
                    trace and not host_only <= got):
                bad.append((cell["name"], trace))
    print(json.dumps({"rehearsed": len(cells), "bad": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
