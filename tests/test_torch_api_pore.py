"""Parity of the port's ``Pore`` (``from_trajectory`` through the batched
column path, ``read_zeopp``, the '.pore' round-trip) with ``amof_tpu``'s
class on the CPU, and the port's refusal of the per-frame path's
options, which it has not ported.

Tolerance: records rel 1e-5, as in test_torch_pore_batch (the same
per-voxel, per-point and per-atom results summed in another order).
"""

import numpy as np
import pytest
import torch

import amof_tpu.pore.core as jpore
import amof_tpu_torch.pore.core as tpore
from amof_tpu.core.frames import FrameBatch as JaxFrameBatch
from amof_tpu_torch import FrameBatch

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
    with pytest.raises(NotImplementedError, match="per-frame"):
        tpore.Pore.from_trajectory(FrameBatch(*slab_glass()), device="cpu",
                                   **KW, **option)


def test_batch_path_errors_propagate():
    """A cell too small for the column plan: ``amof_tpu`` would drop to
    its per-frame path; the port raises the batch path's error."""
    with pytest.raises(NotImplementedError, match="too small"):
        tpore.Pore.from_trajectory(FrameBatch(*slab_glass(n=200, box=16.0)),
                                   device="cpu", **KW)


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
