"""
Host-side frame parallelism (a copy of ``amof_tpu/parallel/host.py``,
threads only).

The reference fans per-frame work out with joblib process pools, with the
worker heuristic max(cpu_count()//2 - 2, 2) from amof/cn.py:79. The
port's per-frame pore path (``pore/core.py``) fans frames out over
threads: its work is device launches and host numpy, which release the
GIL.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List


def default_n_workers() -> int:
    """The reference's worker heuristic (amof/cn.py:79)."""
    return max((os.cpu_count() or 1) // 2 - 2, 2)


def resolve_n_workers(parallel, n_items: int) -> int:
    """Reference semantics: False -> 1, True -> heuristic, int -> that
    many; always capped at the number of items."""
    if parallel is True:
        n = default_n_workers()
    elif parallel is False or parallel is None:
        n = 1
    else:
        n = int(parallel)
    return max(1, min(n, n_items))


def parallel_map(fn: Callable, items: Iterable, parallel) -> List:
    """Order-preserving map over frames with the reference's
    ``parallel`` argument semantics, on host threads (the reference's
    process branch is left out: a process pool is unsafe once CUDA is
    initialised)."""
    items = list(items)
    n = resolve_n_workers(parallel, len(items))
    if n <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(fn, items))
