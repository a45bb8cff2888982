"""
Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc -c`` per source, all started together, and link into one shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``amof_tpu_torch/_build/`` (ignored by git),
under a name keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

``build`` and the first ``library`` call hold one module lock, so threads
of one process (the warmup thread and the first launch, say) build once;
once the library is loaded, ``library()`` returns it without the lock.
Object and temporary files carry the process and thread id, so processes
that build at once never share a path. A failed build is remembered:
every later ``library()`` call raises the same error instead of building
again.

``--fmad=false`` is deliberate: the kernels' integer outputs (histogram
bins, cutoff tests, neighbour slots) must equal the plain PyTorch
versions bit for bit, and eager PyTorch rounds every multiply and add
separately. IEEE ``sqrtf`` and division stay on (no fast math).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from amof_tpu_torch import tracing

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rdf_hist.cu", "window_table.cu", "void_masks.cu",
           "surface_columns.cu", "flood_fill.cu", "warmup.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    "rdf_blocked_launch": (
        _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P,
    ),
    "rdf_hist_launch": (
        _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P, _P, _L, _P, _P,
    ),
    "rdf_hist_geometry": (_I, _I, _I, _I, _I, _P),
    "rdf_root_check_launch": (_P, _P),
    "window_table_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "window_table_geometry": (_I, _I, _I, _I, _I, _P),
    "window_table_slab_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "window_table_slab_geometry": (_I, _I, _I, _I, _I, _P),
    "void_masks_launch": (
        _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P, _I,
        _P, _P, _P, _P,
    ),
    "surface_columns_launch": (
        _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P,
        _P, _I, _F, _F, _I, _I, _I, _P, _P, _P, _P,
    ),
    "surface_columns_geometry": (_I, _P),
    "flood_fill_launch": (_P, _I, _I, _I, _I, _P, _P, _P),
    "flood_fill_geometry": (_I, _I, _I, _P),
    "warmup_copy_launch": (_P, _P, _I, _P),
}

class KernelError(RuntimeError):
    """A kernel library that does not build or load, or a launch that
    fails."""


_lock = threading.RLock()
_lib = None
_error = None  # the exception of a failed library(), raised again


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels of "
        "amof_tpu_torch build from csrc/ at first use"
    )


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libamof_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/ into the shared library unless it is up to date:
    every source compiles in its own nvcc process, all at once, then one
    link. The compiler's register/shared-memory report goes to
    ``_build/ptxas.log``."""
    with _lock:
        return _build()


def _build() -> pathlib.Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    who = f"{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{out.stem}.{who}.{pathlib.Path(s).stem}.o"
            for s in SOURCES]
    tmp = out.with_suffix(f".{who}.tmp")
    with tracing.span("build.nvcc"):
        logs, failed = _compile_and_link(nvcc, objs, tmp)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise KernelError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)  # atomic: no process loads a half-written file
    return out


def _compile_and_link(nvcc, objs, tmp):
    """Every source in its own nvcc process, all at once, then the link
    into ``tmp``; returns (the compiler's logs, the failures)."""
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                          str(CSRC / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        so, se = proc.communicate()
        logs.append(f"== {src}\n{so}{se}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{se[-3000:]}")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stderr[-3000:]}")
    return logs, failed


def _load(path: pathlib.Path) -> ctypes.CDLL:
    """dlopen the library and look each C entry point up once: ``CDLL``
    keeps the function object as an attribute, so ``lib.name`` is a plain
    attribute read afterwards."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; a failed build or
    load raises again on every later call). Once loaded it is returned
    without taking the lock: ``_lib`` is set once, after the load, and
    never cleared. The first load is the span ``build.library``, its
    nvcc run (if any) ``build.nvcc``."""
    global _lib, _error
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _error is not None:
            raise _error
        if _lib is None:
            try:
                with tracing.span("build.library"):
                    _lib = _load(build())
            except KernelError as exc:
                _error = exc
                raise
            except Exception as exc:
                _error = KernelError(f"loading the kernel library failed: "
                                     f"{exc}")
                raise _error from exc
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        fn = library().amof_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise KernelError(
            f"{what}: CUDA launch failed (error {err}: "
            f"{fn(err).decode()})"
        )


def stream_ptr(tensor) -> int:
    """Raw pointer of the current stream of ``tensor``'s CUDA device,
    queried on every launch: a caller may launch under
    ``torch.cuda.stream(...)``, as the warmup does. ``torch.accelerator``
    builds its ``torch.Stream`` in C++, which makes it the cheaper public
    query (``torch.cuda.current_stream`` builds a Python object)."""
    return torch.accelerator.current_stream(tensor.get_device()).native_handle
