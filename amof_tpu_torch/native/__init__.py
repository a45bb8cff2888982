"""
Native (C++) ring engine with build-on-demand ctypes bindings.

The reference delegates its combinatorial graph work to external native
binaries (RINGS Fortran, amof/ring/core.py:258). Here the enumeration
core is a small C++ library (``ringsearch.cpp``, beside this file)
compiled on first use with g++ into ``amof_tpu_torch/_build/`` (ignored
by git), under a name keyed by a hash of the source, and bound through
its plain C ABI with ctypes.

The build writes to a file of its own (process and thread id in the
name) and moves it into place with ``os.replace``, so processes that
build at once never load a half-written library. A failed build raises
``NativeBuildError`` with the command and the compiler's stderr, and
every later call raises it again: there is no silent fallback.
``_ring_census_py`` is the same algorithm in pure Python, the engine's
plain version, which the tests hold the library against.

Heavy all-pairs distance work runs on the caller's device (see
amof_tpu_torch/ops/graph_kernel.py); the C++ consumes the distance
matrix. Periodic graphs pass per-edge image shifts so winding cycles
(infinite periodic paths) are excluded from the ring census.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from amof_tpu_torch import tracing

logger = logging.getLogger(__name__)

SOURCE = pathlib.Path(__file__).parent / "ringsearch.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_LIB = None
_ERROR = None  # the NativeBuildError of a failed build, raised again


class NativeBuildError(RuntimeError):
    """The ring engine did not build or load."""


def pack_shift(s) -> int:
    """Pack an integer image shift (sx, sy, sz) into one int32."""
    return ((int(s[0]) + 128) << 16) | ((int(s[1]) + 128) << 8) | (int(s[2]) + 128)


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"ringsearch_{h.hexdigest()[:16]}.so"


def _compile() -> pathlib.Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    logger.info("building native ring engine: %s", " ".join(cmd))
    try:
        with tracing.span("build.gxx"):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
    except (subprocess.SubprocessError, OSError) as exc:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"building the ring engine failed: {' '.join(cmd)}: {exc}"
        ) from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"building the ring engine failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr[-3000:]}"
        )
    os.replace(tmp, out)  # atomic: no process loads a half-written file
    return out


def get_lib():
    """Load (building if needed) the native library; raises
    ``NativeBuildError`` if it does not build or load, on this call and
    every later one."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    with _lock:
        if _ERROR is not None:
            raise _ERROR
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_compile()))
        except NativeBuildError as exc:
            _ERROR = exc
            raise
        except OSError as exc:
            _ERROR = NativeBuildError(f"loading the ring engine failed: {exc}")
            raise _ERROR from exc
        lib.ring_census.restype = ctypes.c_int
        lib.ring_census.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_void_p,  # edge shifts or NULL
            ctypes.c_void_p,  # dist or NULL
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def _to_csr(adjacency, shifts):
    n = len(adjacency)
    off = np.zeros(n + 1, np.int32)
    for i, nbrs in enumerate(adjacency):
        off[i + 1] = off[i] + len(nbrs)
    idx = np.fromiter(
        (j for nbrs in adjacency for j in nbrs), np.int32, count=off[-1]
    )
    packed = None
    if shifts is not None:
        packed = np.fromiter(
            (pack_shift(s) for row in shifts for s in row),
            np.int32, count=off[-1],
        )
    return off, idx, packed


def ring_census(
    adjacency: List[List[int]],
    max_size: int,
    dist: Optional[np.ndarray] = None,
    max_paths: int = 64,
    max_rings: int = 200000,
    shifts: Optional[Sequence[Sequence]] = None,
) -> Tuple[List[List[int]], int, int]:
    """Primitive-ring census of a (periodic) graph.

    Args:
        adjacency: per-node neighbor lists, edge-resolved (both
            directions; parallel edges through different images listed
            separately).
        max_size: largest ring size (in nodes) to search.
        dist: optional precomputed [n, n] quotient-graph distance matrix
            (uint16; e.g. from the on-device BFS kernel).
        max_paths: cap on enumerated shortest paths per seed pair.
        max_rings: output capacity.
        shifts: per-edge integer image shifts aligned with ``adjacency``
            ([[sx,sy,sz], ...] per node); None for a finite graph.

    Returns:
        (rings, potentially_undiscovered, king_count) — rings as node
        lists in canonical order.
    """
    n = len(adjacency)
    if n == 0:
        return [], 0, 0
    lib = get_lib()
    off, idx, packed = _to_csr(adjacency, shifts)
    sizes = np.zeros(max_rings, np.int32)
    nodes = np.zeros(max_rings * max(max_size, 1), np.int32)
    undiscovered = ctypes.c_int32(0)
    king = ctypes.c_int32(0)
    dist_ptr = None
    if dist is not None:
        dist = np.ascontiguousarray(dist, dtype=np.uint16)
        dist_ptr = dist.ctypes.data_as(ctypes.c_void_p)
    shift_ptr = None
    if packed is not None:
        shift_ptr = packed.ctypes.data_as(ctypes.c_void_p)
    count = lib.ring_census(
        n, off, idx, shift_ptr, dist_ptr, max_size, max_paths,
        max_rings, sizes, nodes,
        ctypes.byref(undiscovered), ctypes.byref(king),
    )
    rings = []
    pos = 0
    for i in range(count):
        rings.append(nodes[pos : pos + sizes[i]].tolist())
        pos += sizes[i]
    return rings, int(undiscovered.value), int(king.value)


# ---------------------------------------------------------------------------
# The plain version: the same algorithm in pure Python (tests only)
# ---------------------------------------------------------------------------

_INF = np.iinfo(np.uint16).max


def _bfs(adjacency, src, skip=None):
    n = len(adjacency)
    dist = np.full(n, _INF, np.int64)
    if src == skip:
        return dist
    dist[src] = 0
    frontier = [src]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in adjacency[u]:
                if v == skip:
                    continue
                if dist[v] > d:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def _all_shortest_paths(adjacency, shifts, dist_from_src, src, dst, max_paths):
    """[(nodes, shift_sum)] of all shortest paths src -> dst."""
    out = []

    def dfs(u, path, acc):
        if len(out) >= max_paths:
            return
        if dist_from_src[u] == 0:
            out.append((path[::-1], tuple(-a for a in acc)))
            return
        for e, v in enumerate(adjacency[u]):
            if dist_from_src[v] + 1 == dist_from_src[u]:
                sh = shifts[u][e] if shifts is not None else (0, 0, 0)
                dfs(v, path + [v],
                    (acc[0] + sh[0], acc[1] + sh[1], acc[2] + sh[2]))

    dfs(dst, [dst], (0, 0, 0))
    return out


def _canonical(cyc):
    n = len(cyc)
    mpos = int(np.argmin(cyc))
    fwd = tuple(cyc[(mpos + i) % n] for i in range(n))
    bwd = tuple(cyc[(mpos - i) % n] for i in range(n))
    return min(fwd, bwd)


def _is_primitive(cyc, dist):
    m = len(cyc)
    for i in range(m):
        for j in range(i + 1, m):
            ring_d = min(j - i, m - (j - i))
            if dist[cyc[i]][cyc[j]] < ring_d:
                return False
    return True


def _ring_census_py(adjacency, max_size, dist=None, max_paths=64, shifts=None):
    n = len(adjacency)
    if dist is None:
        dist = np.stack([_bfs(adjacency, s) for s in range(n)])
    rings = set()
    king = set()
    undiscovered = 0
    half = max_size // 2
    for s in range(n):
        ds = dist[s]
        # King rings + undiscovered
        nbrs = adjacency[s]
        for a_i in range(len(nbrs)):
            u = nbrs[a_i]
            if u == s:
                continue
            dist_skip = _bfs(adjacency, u, skip=s)
            for b_i in range(a_i + 1, len(nbrs)):
                v = nbrs[b_i]
                if v == s or v == u:
                    continue
                duv = dist_skip[v]
                if duv >= _INF:
                    continue
                if duv + 2 > max_size:
                    undiscovered += 1
                    continue
                paths = _all_shortest_paths(
                    adjacency, shifts, dist_skip, u, v, 1
                )
                if paths:
                    cyc = paths[0][0] + [s]
                    if len(set(cyc)) == len(cyc):
                        king.add(_canonical(cyc))
        # even rings
        for m_node in range(s + 1, n):
            k = ds[m_node]
            if k < 2 or k > half:
                continue
            paths = _all_shortest_paths(adjacency, shifts, ds, s, m_node,
                                        max_paths)
            for a_i in range(len(paths)):
                for b_i in range(a_i + 1, len(paths)):
                    (pa, sa), (pb, sb) = paths[a_i], paths[b_i]
                    if sa != sb:
                        continue  # winding cycle
                    if set(pa[1:-1]) & set(pb[1:-1]):
                        continue
                    cyc = pa[:-1] + pb[:0:-1]
                    if len(cyc) != 2 * k or len(set(cyc)) != len(cyc):
                        continue
                    if _is_primitive(cyc, dist):
                        rings.add(_canonical(cyc))
        # odd rings
        for u in range(n):
            k = ds[u]
            if k < 1 or k >= _INF or 2 * k + 1 > max_size:
                continue
            for e, v in enumerate(adjacency[u]):
                if v < u or ds[v] != k:
                    continue
                sh = shifts[u][e] if shifts is not None else (0, 0, 0)
                pu = _all_shortest_paths(adjacency, shifts, ds, s, u, max_paths)
                pv = _all_shortest_paths(adjacency, shifts, ds, s, v, max_paths)
                for pa, sa in pu:
                    for pb, sb in pv:
                        total = (sa[0] + sh[0], sa[1] + sh[1], sa[2] + sh[2])
                        if total != sb:
                            continue  # winding
                        if set(pa[1:]) & set(pb[1:]):
                            continue
                        cyc = pa + pb[:0:-1]
                        if len(cyc) != 2 * k + 1 or len(set(cyc)) != len(cyc):
                            continue
                        if _is_primitive(cyc, dist):
                            rings.add(_canonical(cyc))
    return [list(r) for r in sorted(rings)], undiscovered, len(king)
