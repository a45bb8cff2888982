"""Parity of the port's RDF entry points (``Rdf.from_trajectory``, the
RDF-integral ``CoordinationNumber``, ``get_coordination_number``) with
``amof_tpu``'s classes on the CPU, on the same numpy trajectories.

Tolerances:
  * exact on dyadic-grid positions in cells with a power-of-two
    diagonal (see test_torch_rdf: every product in the distance chain is
    then exact, so XLA:CPU's FMA contraction cannot move a pair across a
    bin edge): the counts are integers and the volume, a power of two,
    scales them exactly, so the volume-weighted sums are exact in both
    packages;
  * rel 1e-6 on volume-weighted counts with generic frame weights:
    ``amof_tpu`` sums the weighted float32 frames with float32 Neumaier
    carries, the port in float64.

The port takes kernel #1's plain version on the species-blocked layout
and kernel #2's on the small (unblockable) cell and in the RDF-integral
CN, as it does on the card.
"""

import numpy as np
import pytest
import torch

import amof_tpu.rdf as jrdf
import amof_tpu_torch.rdf as trdf
from amof_tpu.core.frames import FrameBatch as JaxFrameBatch
from amof_tpu_torch import FrameBatch
from amof_tpu_torch.ops import rdf_kernel

from test_torch_pipeline import CUTOFFS, glass

torch.set_num_threads(2)


def batches(pos, cells, species):
    step = np.arange(len(pos), dtype=np.int32)
    return (FrameBatch(pos, cells, species, step),
            JaxFrameBatch(pos, cells, species, step))


def assert_frames_equal(got, ref):
    assert list(got.columns) == list(ref.columns)
    assert got.shape == ref.shape and len(got) > 0
    np.testing.assert_array_equal(got.to_numpy(np.float64),
                                  ref.to_numpy(np.float64))


@pytest.mark.parametrize("case,kernel", [
    ("cubic", "rdf_counts_blocked"),
    ("triclinic", "rdf_counts_blocked"),
    ("small_cell", "rdf_counts"),
])
def test_rdf_from_trajectory_matches_amof_tpu(case, kernel, monkeypatch):
    if case == "small_cell":
        arrays = glass(n_frames=3, n_atoms=272, box=16.0, seed=3)
    else:
        arrays = glass(n_frames=3, n_atoms=2048, triclinic=case == "triclinic")
    batch, jb = batches(*arrays)
    calls = []
    wrapped = getattr(rdf_kernel, kernel)
    monkeypatch.setattr(rdf_kernel, kernel,
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    # rmax below half the triclinic cell's smallest width (see
    # test_torch_pipeline.test_triclinic_monolithic_matches_jax)
    got = trdf.Rdf.from_trajectory(batch, dr=0.02, rmax=7.5, device="cpu")
    ref = jrdf.Rdf.from_trajectory(jb, dr=0.02, rmax=7.5)
    assert len(calls) == 3  # one histogram per frame, on the kernel's path
    assert_frames_equal(got.data, ref.data)
    assert float(got.data["X-X"].sum()) > 0


def test_weighted_trajectory_counts_match_amof_tpu():
    """Generic per-frame weights (the NPT volumes' role)."""
    import jax.numpy as jnp

    from amof_tpu.ops import pair_engine as jax_pair
    from amof_tpu_torch.ops import pair_engine

    pos, cells, species = glass(n_frames=4, n_atoms=1024)
    z = np.unique(species)
    sp = np.searchsorted(z, species).astype(np.int32)
    weights = np.array([32768.7, 31001.3, 35012.9, 29999.1], np.float32)
    ref = np.asarray(jax_pair.trajectory_rdf_counts(
        jnp.asarray(pos), jnp.asarray(cells), jnp.asarray(sp), 0.05, 4, 320,
        method="scatter", frame_weights=jnp.asarray(weights)), np.float64)
    got = pair_engine.trajectory_rdf_counts(
        torch.from_numpy(pos), torch.from_numpy(cells), torch.from_numpy(sp),
        0.05, 4, 320, frame_weights=torch.from_numpy(weights)).numpy()
    assert got.dtype == np.float64 and ref.sum() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rmax", [5.0, 100.0])
def test_rdf_rmax_rule_matches_amof_tpu(rmax):
    """An explicit rmax, and one past half the cell (clamped)."""
    batch, jb = batches(*glass(n_frames=2, n_atoms=2048))
    got = trdf.Rdf.from_trajectory(batch, dr=0.05, rmax=rmax, device="cpu")
    ref = jrdf.Rdf.from_trajectory(jb, dr=0.05, rmax=rmax)
    assert_frames_equal(got.data, ref.data)


def test_rdf_integral_cn_matches_amof_tpu():
    """Kernel #2's plain version per frame at the default 0.0001 A bins.
    (At dr 0.001 or 0.002 ``amof_tpu``'s classes bin with float32
    1/float32(dr), one ulp below the port's and the Pallas kernels'
    float32(1/dr); ROADMAP Q3.)"""
    batch, jb = batches(*glass(n_frames=3, n_atoms=1024, seed=7))
    cut = {"Zn-N": 2.0, "C-H": 1.3}
    got = trdf.CoordinationNumber.from_trajectory(batch, cut, device="cpu")
    ref = jrdf.CoordinationNumber.from_trajectory(jb, cut)
    assert_frames_equal(got.data, ref.data)
    assert (got.data["C-H"] > 0).all()


def test_get_coordination_number_and_round_trips(tmp_path):
    batch, _ = batches(*glass(n_frames=2, n_atoms=1024))
    rdf = trdf.Rdf.from_trajectory(batch, dr=0.02, device="cpu")
    density = 1024 / 32.0**3
    assert rdf.get_coordination_number("Zn-N", 2.0, density) == \
        jrdf.get_coordination_number(rdf.data["r"], rdf.data["Zn-N"], 2.0,
                                     density)
    rdf.write_to_file(tmp_path / "out")
    back = trdf.Rdf.from_file(tmp_path / "out.rdf")
    assert_frames_equal(back.data, rdf.data)
    plotter = trdf.RdfPlotter.from_multiple_rdf([tmp_path / "out"], ["run"])
    assert_frames_equal(plotter.multiple_rdf_data["run"], rdf.data)
    cn = trdf.CoordinationNumber.from_trajectory(batch, {"Zn-N": 2.0},
                                                 dr=0.01, device="cpu")
    cn.write_to_file(tmp_path / "out")
    assert_frames_equal(trdf.CoordinationNumber.from_file(
        tmp_path / "out").data, cn.data)


@pytest.mark.parametrize("entry", ["rdf", "rdf_cn"])
def test_rdf_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    batch, _ = batches(*glass(n_frames=1, n_atoms=64, box=8.0))
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "rdf":
            trdf.Rdf.from_trajectory(batch)
        else:
            trdf.CoordinationNumber.from_trajectory(batch, CUTOFFS)
