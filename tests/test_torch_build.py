"""The kernel build under concurrent callers, and the runtime warmup, on a
machine with no nvcc and no card.

A fake ``nvcc`` (a shell script on PATH) writes the files it is asked
for and logs each call, so the tests count builds; loading the "library"
is stubbed out. The warmup tests pretend a card is present only as far
as the warmup thread's build step, which fails or is stubbed before any
CUDA call.
"""

import importlib
import os
import threading

import pytest
import torch

from amof_tpu_torch import _build, tracing, warmup

wmod = importlib.import_module("amof_tpu_torch.warmup")

FAKE_NVCC = """#!/bin/sh
echo call >> "{log}"
sleep 0.2
{fail}
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A fresh build state with a fake nvcc; returns (set_fail, calls)."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()

    def write(fail):
        nvcc.write_text(FAKE_NVCC.format(
            log=log, fail="exit 3" if fail else ""))
        nvcc.chmod(0o755)

    write(False)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_error", None)
    monkeypatch.setattr(_build, "_load", lambda path: ("loaded", path))
    monkeypatch.setattr(wmod, "_handle", None)

    def calls():
        return len(log.read_text().split()) if log.exists() else 0

    return write, calls


def test_concurrent_library_calls_build_once(fake_build):
    _, calls = fake_build
    results, errors = [], []

    def call():
        try:
            results.append(_build.library())
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert calls() == len(_build.SOURCES) + 1  # one build: compiles + link
    assert results[0] is results[1]
    assert results[0][1] == _build.library_path()
    assert _build.library_path().exists()
    assert not list(_build.BUILD_DIR.glob("*.o"))
    assert not list(_build.BUILD_DIR.glob("*.tmp"))
    assert _build.library() is results[0] and calls() == len(
        _build.SOURCES) + 1


def test_loaded_library_is_returned_without_the_lock(monkeypatch):
    """Once the library is loaded, ``library()`` returns it while another
    thread holds the build lock."""
    loaded = object()
    monkeypatch.setattr(_build, "_lib", loaded)
    monkeypatch.setattr(_build, "_error", None)
    held, release = threading.Event(), threading.Event()

    def hold():
        with _build._lock:
            held.set()
            release.wait(30)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert held.wait(30)
        got = []
        caller = threading.Thread(target=lambda: got.append(_build.library()))
        caller.start()
        caller.join(10)
        assert not caller.is_alive() and got == [loaded]
    finally:
        release.set()
        holder.join()


def test_failed_build_raises_again_without_rebuilding(fake_build):
    write, calls = fake_build
    write(fail=True)
    with pytest.raises(RuntimeError, match="nvcc failed") as first:
        _build.library()
    n = calls()
    assert n == len(_build.SOURCES)  # every source tried once, no link
    with pytest.raises(RuntimeError) as again:
        _build.library()
    assert again.value is first.value
    assert calls() == n


def test_warmup_reraises_a_build_failure(fake_build, monkeypatch):
    """The thread's build fails before any CUDA call; block=True raises
    it, and so does the next library() call."""
    write, calls = fake_build
    write(fail=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    handle = warmup(device="cuda")
    assert handle is not None and handle is warmup(device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        warmup(block=True, device="cuda")
    assert isinstance(handle.error, RuntimeError)
    with pytest.raises(RuntimeError) as again:
        _build.library()
    assert again.value is handle.error
    assert calls() == len(_build.SOURCES)


@pytest.mark.parametrize("entry", ["fused", "pore"])
def test_step_raises_a_warmup_launch_failure(entry, fake_build, monkeypatch):
    """The build succeeds and the warmup's launch then fails: the entry
    point's step waits for the handle and raises that failure."""
    import numpy as np

    from amof_tpu_torch.parallel import pipeline
    from amof_tpu_torch.pore import batch as pore_batch
    from amof_tpu_torch.core.frames import FrameBatch

    def fail(device):
        raise RuntimeError("warmup_copy: CUDA launch failed (stub)")

    monkeypatch.setattr(wmod, "_first_launch", fail)
    for mod in (pipeline, pore_batch):  # start the thread on the CPU too
        monkeypatch.setattr(mod, "warmup", lambda device: wmod.Warmup(device))
    rng = np.random.default_rng(0)
    n, box = 1024, 32.0  # the smallest carbon system the pore column plan takes
    batch = FrameBatch(
        positions=(rng.random((2, n, 3)) * box).astype(np.float32),
        cell=np.tile(np.eye(3, dtype=np.float32) * box, (2, 1, 1)),
        species=np.full(n, 6, np.int32),
        step=np.arange(2, dtype=np.int32),
    )
    if entry == "fused":
        run = pipeline.FusedAnalysis({"C-C": 1.7}, with_msd=False).run
    else:
        run = pore_batch.BatchedPore(num_samples=20000, resolution=1.0,
                                     radii={"C": 1.5}).run
    with pytest.raises(RuntimeError, match=r"launch failed \(stub\)"):
        run(batch, device="cpu")
    assert _build.library() is not None  # the build itself went through


@pytest.mark.parametrize("case", ["cpu", "no_warmup_env"])
def test_warmup_is_a_no_op(case, fake_build, monkeypatch):
    _, calls = fake_build
    if case == "no_warmup_env":
        monkeypatch.setenv("AMOF_TPU_NO_WARMUP", "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        device = "cuda"
    else:
        monkeypatch.delenv("AMOF_TPU_NO_WARMUP", raising=False)
        device = "cpu"
    assert warmup(device=device) is None
    assert warmup(block=True, device=device) is None
    assert wmod._handle is None and calls() == 0


def test_warmup_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("AMOF_TPU_NO_WARMUP", raising=False)
    monkeypatch.setattr(wmod, "_handle", None)
    with pytest.raises(RuntimeError, match="cuda"):
        warmup()


def test_warmup_copy_plain_on_cpu():
    src = torch.arange(1024, dtype=torch.float32).reshape(wmod.SHAPE)
    before = tracing.snapshot()
    out = wmod.warmup_copy(src)
    assert torch.equal(out, src) and out.data_ptr() != src.data_ptr()
    # CPU calls do not count
    assert "launch.warmup_copy" not in tracing.diff(tracing.snapshot(),
                                                    before)["counts"]
