"""
Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``amof_tpu_torch/_build/`` (ignored by
git), under a name keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

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
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rdf_hist.cu", "window_table.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns cudaError_t as int)
_SIGNATURES = {
    "rdf_hist_launch": (
        _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P,
    ),
    "window_table_launch": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    "window_table_slab_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
        _P,
    ),
}

_lib = None
build_seconds = None  # wall time of the last build (None: loaded as-is)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels of "
        "amof_tpu_torch build from csrc/ at first use"
    )


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libamof_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/ into the shared library unless it is up to date.
    The compiler's register/shared-memory report goes to
    ``_build/ptxas.log``."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: no process loads a half-written file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        fn = library().amof_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA launch failed (error {err}: "
            f"{fn(err).decode()})"
        )


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
