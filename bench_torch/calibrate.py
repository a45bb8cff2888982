#!/usr/bin/env python3
"""Readings behind the limits of ``correct``, in one process on the card:
for each seed, the cell's pieces, one unit of the program on the first
piece (through the timed path's own runner, after one warm-up unit), the
plain reference in float64, and the control: the same reference
computed one precision below the configuration's (float32 -> bfloat16)
put in the program's place. Prints one JSON line a seed with the
program's numbers (the lower readings) and the control's (the upper).

    python3 bench_torch/calibrate.py --workload glass9792.fused \\
        --seeds 101 102 103 [--control-seeds 3]

Not run by the benchmark's own runs. A limit sits above the largest
program reading and below the smallest control reading (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402

CONTROL_DTYPE = {"float32": "bfloat16", "float64": "float32"}


def readings(bench, cell, seeds, n_control, device):
    import torch

    config = bench.config(cell["config"])
    traffic = harness.load_traffic(cell)
    kind = harness.kind_module(traffic)
    low = getattr(torch, CONTROL_DTYPE[config["precision"]])
    runner = kind.Runner(config, traffic, device)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        piece = harness.make_pieces(config, traffic, seed, device)[0]
        if i == 0:
            runner.unit(piece)
        out = runner.unit(piece)
        ref = kind.reference(config, traffic, piece, device)
        line = {"workload": cell["name"], "seed": seed,
                "program": kind.compare(out, ref, config, traffic)}
        if i < n_control:
            ctl = kind.reference(config, traffic, piece, device, low)
            line["control"] = kind.compare(ctl, ref, config, traffic)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for name in args.workload:
        readings(bench, bench.workload(name), args.seeds,
                 args.control_seeds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
