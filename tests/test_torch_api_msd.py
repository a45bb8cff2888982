"""Parity of the port's ``WindowMsd`` and ``DirectMsd`` (``from_trajectory``,
``compute_msd_of_m``, ``compute_species_msd``, the '.msd' round-trip)
with ``amof_tpu``'s classes on the CPU, on the same numpy trajectories
(the bench recipe's thermal random walk, wrapped into the box).

Tolerance: rtol 1e-4 (float32 FFT round-off, the two FFT libraries sum in
different orders), plus 8 float32 ulps of the mean squared centered
position, the size of the terms that cancel in S(m) = S1(m) - 2 AC(m)
(test_torch_bad_msd). ``compute_msd_of_m`` is the same float64 numpy
recurrence in both packages and must agree exactly.
"""

import numpy as np
import pytest
import torch

import amof_tpu.msd as jmsd
import amof_tpu_torch.msd as tmsd

from test_torch_api_rdf import batches
from test_torch_pipeline import glass, msd_atol

torch.set_num_threads(2)


def walk(n_frames=40, n_atoms=512, triclinic=False):
    return glass(n_frames=n_frames, n_atoms=n_atoms, seed=9,
                 triclinic=triclinic)


def assert_msd_close(got, ref, pos):
    assert list(got.columns) == list(ref.columns)
    assert got.shape == ref.shape and len(got) > 1
    np.testing.assert_allclose(got.to_numpy(np.float64),
                               ref.to_numpy(np.float64), rtol=1e-4,
                               atol=msd_atol(pos))


@pytest.mark.parametrize("kw,triclinic", [
    (dict(delta_time=2, timestep=1), False),
    (dict(delta_time=10, timestep=5, max_time=60, unwrap=True), False),
    (dict(delta_time=1, origin_policy="standard"), True),
])
def test_window_msd_matches_amof_tpu(kw, triclinic):
    arrays = walk(triclinic=triclinic)
    batch, jb = batches(*arrays)
    got = tmsd.WindowMsd.from_trajectory(batch, device="cpu", **kw)
    ref = jmsd.WindowMsd.from_trajectory(jb, **kw)
    assert_msd_close(got.data, ref.data, arrays[0])
    assert got.data["X"].iloc[-1] > 0


def test_window_msd_rejects_delta_time_below_timestep():
    batch, jb = batches(*walk(n_frames=8, n_atoms=64))
    with pytest.raises(ValueError):
        jmsd.WindowMsd.from_trajectory(jb, delta_time=1, timestep=2)
    with pytest.raises(ValueError):
        tmsd.WindowMsd.from_trajectory(batch, delta_time=1, timestep=2,
                                       device="cpu")


def test_compute_msd_of_m_matches_amof_tpu():
    rng = np.random.default_rng(4)
    delta = rng.normal(0, 0.2, (30, 12, 3))
    for m in (1, 4, 9):
        assert tmsd.WindowMsd.compute_msd_of_m(delta, m) == \
            jmsd.WindowMsd.compute_msd_of_m(delta, m)


def test_direct_msd_matches_amof_tpu():
    arrays = walk()
    batch, jb = batches(*arrays)
    got = tmsd.DirectMsd.from_trajectory(batch, delta_Step=2, device="cpu")
    ref = jmsd.DirectMsd.from_trajectory(jb, delta_Step=2)
    assert_msd_close(got.data, ref.data, arrays[0])
    assert got.data["X"].iloc[-1] > 0
    np.testing.assert_allclose(
        tmsd.DirectMsd().compute_species_msd(batch, 30, device="cpu"),
        jmsd.DirectMsd().compute_species_msd(jb, 30), rtol=1e-4)


def test_msd_round_trip_and_default_device(tmp_path):
    batch, _ = batches(*walk(n_frames=8, n_atoms=64))
    msd = tmsd.WindowMsd.from_trajectory(batch, delta_time=1, device="cpu")
    msd.write_to_file(tmp_path / "out")
    back = tmsd.WindowMsd.from_file(tmp_path / "out.msd")
    np.testing.assert_array_equal(back.data.to_numpy(), msd.data.to_numpy())
    if not torch.cuda.is_available():
        for cls in (tmsd.WindowMsd, tmsd.DirectMsd):
            with pytest.raises(RuntimeError, match="cuda"):
                cls.from_trajectory(batch)
