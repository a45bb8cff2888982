"""Seconds the step waited for the runtime warmup (the kernel library's
build and load, the first launch) in the run: the program's span
``warmup.wait``; 0 where no warmup ran (the CPU)."""

from bench_torch import program


def read(tr):
    snap = program.totals()
    if snap is None:
        return None
    return snap["spans"].get("warmup.wait", [0, 0.0, 0.0])[1]
