"""The comparison that decides ``correct`` fails where it must, at a size
a CPU test run holds (``rehearse.small``), against each cell's own limits:

  * the control: the plain reference one precision below the
    configuration's (float32 -> bfloat16) in the program's place;
  * the whole run (pieces, window, sample, reference, comparison) with the
    timed path broken underneath, once for each fault an analysis cell
    can have: a step that returns its state unchanged, half of the batch
    left out (its mean taken over the rest), one answer altered where it
    is produced. There is no exchange between cards to leave out: every
    cell runs on one card.

    python3 -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import harness, rehearse  # noqa: E402

BENCH = harness.Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
SEED = 2**34 + 99


def _small(name):
    cell = BENCH.workload(name)
    return cell, *rehearse.small(BENCH.config(cell["config"]),
                                 harness.load_traffic(cell))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    import torch

    cell, config, traffic = _small(name)
    kind = harness.kind_module(traffic)
    limits = harness.load_json(harness.HERE / "limits" / f"{name}.json")
    piece = harness.make_pieces(config, traffic, SEED, "cpu")[0]
    ref = kind.reference(config, traffic, piece, "cpu")
    ctl = kind.reference(config, traffic, piece, "cpu", torch.bfloat16)
    nums = kind.compare(ctl, ref, config, traffic)
    assert any(not v <= limits[k] for k, v in nums.items()), nums


def zeroed(out):
    if isinstance(out, dict):
        return {k: zeroed(v) for k, v in out.items()}
    return np.zeros_like(np.asarray(out, np.float64))


class StateUnchanged:
    """Runs the program and returns its accumulators as they started
    (zeros of every output's shape): a step that changed nothing."""

    def __init__(self, runner):
        self.runner = runner

    def unit(self, piece):
        return zeroed(self.runner.unit(piece))


class Piecewise:
    """Runs the program on a broken copy of each piece."""

    def __init__(self, runner, transform):
        self.runner, self.transform = runner, transform

    def unit(self, piece):
        return self.runner.unit(self.transform(piece))


def half_left_out(piece):
    """The first half of the frames twice: the second half never reaches
    the program, and sums and means are those of the first half."""
    pos = piece["positions"]
    half = pos[: len(pos) // 2]
    return dict(piece, positions=np.concatenate([half, half]))


def one_answer_altered(piece):
    """Frame 1 analysed with its atoms in reverse order (every species
    on another atom's site): one frame's answer wrong."""
    pos = piece["positions"].copy()
    pos[1] = pos[1][::-1]
    return dict(piece, positions=pos)


FAULTS = {
    "state_unchanged": StateUnchanged,
    "half_left_out": lambda r: Piecewise(r, half_left_out),
    "answer_altered": lambda r: Piecewise(r, one_answer_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_reads_not_correct(name, fault):
    cell, config, traffic = _small(name)
    res = harness.run_cell(BENCH, cell, SEED, 0.0, False, "cpu",
                           time.perf_counter(), wrap_runner=FAULTS[fault],
                           config=config, traffic=traffic)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_reads_correct(name):
    cell, config, traffic = _small(name)
    res = harness.run_cell(BENCH, cell, SEED, 0.0, False, "cpu",
                           time.perf_counter(), config=config,
                           traffic=traffic)
    assert res["correct"] is True, res["checks"]
