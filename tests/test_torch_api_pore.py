"""Parity of the port's ``Pore`` (``from_trajectory`` through the batched
column path and through the per-frame path that options outside the
batchable set take, ``read_zeopp``, the '.pore' round-trip) with
``amof_tpu``'s class on the CPU, and a kernel launch failure, which
reaches the caller of either path instead of dropping frames.

Tolerance: records rel 1e-5, as in test_torch_pore_batch (the same
per-voxel, per-point and per-atom results summed in another order); the
per-frame path's arrays (histograms, blocking spheres) exactly.
"""

import pytest
import torch

import amof_tpu.pore.core as jpore
import amof_tpu_torch.pore.core as tpore
from amof_tpu.core.frames import FrameBatch as JaxFrameBatch
from amof_tpu_torch import FrameBatch
from amof_tpu_torch._build import KernelError
from amof_tpu_torch.pore import grid_kernel

from test_torch_pore_batch import KW, assert_records_close, slab_glass

torch.set_num_threads(2)


def test_pore_matches_amof_tpu(tmp_path):
    arrays = slab_glass()
    got = tpore.Pore.from_trajectory(FrameBatch(*arrays), delta_Step=10,
                                     first_frame=100, device="cpu", **KW)
    ref = jpore.Pore.from_trajectory(JaxFrameBatch(*arrays), delta_Step=10,
                                     first_frame=100, **KW)
    assert list(got.data.columns) == list(ref.data.columns)
    assert list(got.data["Step"]) == list(ref.data["Step"]) == [100, 110]
    assert_records_close(got.data.to_dict("records"),
                         ref.data.to_dict("records"))
    assert (got.data["ASA_A^2"] > 0).all() and (got.data["AV_A^3"] > 0).all()
    got.write_to_file(tmp_path / "out")
    back = tpore.Pore.from_file(tmp_path / "out.pore")
    assert back.data.equals(got.data)


@pytest.mark.parametrize("option", [dict(psd=True), dict(chan=True),
                                    dict(mass={"C": 12.0}), dict(block=True)])
def test_per_frame_options_raise(option):
    """Options outside the batchable set take the per-frame path in both
    packages (the test's name is from when the port refused them)."""
    arrays = slab_glass()
    got = tpore.Pore.from_trajectory(FrameBatch(*arrays), device="cpu",
                                     **KW, **option)
    ref = jpore.Pore.from_trajectory(JaxFrameBatch(*arrays), **KW, **option)
    assert list(got.data.columns) == list(ref.data.columns)
    assert list(got.data["Step"]) == list(ref.data["Step"]) == [0, 1]
    assert_records_close(got.data.to_dict("records"),
                         ref.data.to_dict("records"))
    assert (got.data["ASA_A^2"] > 0).all()


@pytest.mark.parametrize("option", [{}, dict(psd=True)])
def test_batch_path_errors_propagate(option, monkeypatch):
    """A launch failure of kernel #7 (stubbed: the flood-fill wrapper
    raises as ``_build.check`` does) reaches the caller of the batched
    path and of the per-frame path; no frame is dropped."""
    def fail(init, periodic):
        raise KernelError("flood_fill: CUDA launch failed (error 700: "
                          "stub)")

    monkeypatch.setattr(grid_kernel, "propagate_fixpoint", fail)
    with pytest.raises(KernelError, match=r"launch failed .*stub"):
        tpore.Pore.from_trajectory(FrameBatch(*slab_glass()), device="cpu",
                                   **KW, **option)


def test_read_zeopp_matches_amof_tpu(tmp_path):
    path = tmp_path / "frame.sa"
    path.write_text(
        "@ frame.sa Unitcell_volume: 4380.5   Density: 1.21   ASA_A^2: "
        "12.5 ASA_m^2/cm^3: 28.6 ASA_m^2/g: 23.6 NASA_A^2: 0 "
        "NASA_m^2/cm^3: 0 NASA_m^2/g: 0\n")
    got = tpore.Pore.read_zeopp(path)
    assert got == jpore.Pore.read_zeopp(path)
    assert got["ASA_A^2"] == 12.5


def test_pore_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpore.Pore.from_trajectory(FrameBatch(*slab_glass()), **KW)
