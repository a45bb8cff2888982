"""
Runtime warmup: build the kernel library and make one trivial launch
early, off the caller's thread, so the one-time costs overlap host work.

Counterpart of ``amof_tpu/warmup.py`` ``warmup_mosaic``, which dispatches
an 8x128 float32 Pallas copy without blocking so the TPU runtime's
one-time initialisation overlaps the host's preparation. On the card the
one-time costs are the nvcc build of ``csrc/`` (``_build.py``), the
``dlopen`` of the library, CUDA context creation and the first module
load. ``warmup()`` starts a daemon thread that runs ``_build.library()``
and then launches the hand-written ``warmup_copy`` kernel
(``csrc/warmup.cu``, 8x128 float32) on a side stream, records a CUDA
event, and returns at once with a handle. ``FusedAnalysis.prepare`` and
``BatchedPore.prepare`` call it before their host layout work, and their
step functions wait for it (``after_warmup``) before their first launch.

Unlike ``amof_tpu``, failures are not swallowed: the thread keeps its
exception, ``warmup(block=True)`` (or ``handle.wait()``) raises it, as
does every step function gated on the handle, and a failed build also
raises again at the next ``_build.library()`` call.
``warmup`` is a no-op returning None on the CPU and when
``AMOF_TPU_NO_WARMUP`` is set; CUDA without a card raises, as
``resolve_device`` (the port's one device check, here with the rest of
the device's start-up) does. Once per process.
"""

from __future__ import annotations

import os
import threading

import torch

from amof_tpu_torch import _build, tracing

SHAPE = (8, 128)

_lock = threading.Lock()
_handle = None


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises for CUDA without a card (the
    port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def warmup_copy_plain(src):
    """Plain PyTorch version of ``warmup_copy``."""
    dst = torch.empty_like(src)
    dst.copy_(src)
    return dst


def warmup_copy(src):
    """Kernel #9: a copy of a contiguous float32 tensor whose size is a
    multiple of 4 (8x128 in the warmup). CPU tensors take the plain
    version."""
    if src.is_cpu:
        return warmup_copy_plain(src)
    ptr, n = src.data_ptr(), src.numel()
    if (src.dtype != torch.float32 or not src.is_contiguous() or n % 4
            or ptr % 16):
        raise ValueError("src must be contiguous float32, 16-byte aligned "
                         "(the kernel copies float4), with a size "
                         "divisible by 4")
    dst = torch.empty_like(src)
    err = _build.library().warmup_copy_launch(ptr, dst.data_ptr(), n,
                                              _build.stream_ptr(src))
    _build.check(err, "warmup_copy")
    tracing.count("launch.warmup_copy")  # CPU calls do not count
    return dst


class Warmup:
    """Handle of this process's warmup: the thread, its exception (None
    when it ran) and the CUDA event recorded after the launch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.error = None
        self.event = None
        self._tensors = None  # keeps the copy's buffers alive
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="amof_tpu_torch-warmup")
        self.thread.start()

    def _run(self):
        try:
            _build.library()
            self._tensors, self.event = _first_launch(self.device)
        except Exception as exc:  # kept for wait(), never swallowed
            self.error = exc

    def wait(self) -> "Warmup":
        """Join the thread, raise its exception, wait for the copy."""
        self.thread.join()
        if self.error is not None:
            raise self.error
        self.event.synchronize()
        return self


def _first_launch(device):
    """Launch ``warmup_copy`` on a side stream; returns (its buffers,
    the event recorded after it)."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        src = torch.ones(SHAPE, dtype=torch.float32, device=device)
        dst = warmup_copy(src)
        event = torch.cuda.Event()
        event.record(stream)
    return (src, dst), event


def after_warmup(handle, step_fn):
    """``step_fn`` that first waits for the warmup ``handle`` (None:
    ``step_fn`` itself), so a failed warmup build or launch raises before
    the step's first launch instead of staying in the handle. The wait is
    the span ``warmup.wait``."""
    if handle is None:
        return step_fn

    def step(*args):
        with tracing.span("warmup.wait"):
            handle.wait()
        return step_fn(*args)

    return step


def warmup(block: bool = False, device="cuda"):
    """Start (or, with ``block``, await) the once-per-process warmup on
    ``device``. Returns its ``Warmup`` handle, or None on the CPU and
    under ``AMOF_TPU_NO_WARMUP``."""
    global _handle
    if os.environ.get("AMOF_TPU_NO_WARMUP"):
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    with _lock:
        if _handle is None:
            _handle = Warmup(dev)
        handle = _handle
    return handle.wait() if block else handle
