"""The port's ``Trajectory.from_traj``: xyz and extxyz are read, and any
other ``format`` raises instead of being read as xyz."""

import pathlib

import numpy as np
import pytest

from amof_tpu_torch.core.frames import Trajectory

XYZ = pathlib.Path(__file__).resolve().parents[1] / "example_reduced.xyz"


@pytest.mark.parametrize("fmt", [None, "xyz", "extxyz"])
def test_from_traj_reads_xyz(fmt, tmp_path):
    two = tmp_path / "two.xyz"
    two.write_text(XYZ.read_text() * 2)
    traj = Trajectory.from_traj(two, format=fmt)
    ref = Trajectory.from_traj(two)
    assert len(traj.traj) == 2 and len(traj.traj[0].numbers) == 48
    for a, b in zip(traj.traj, ref.traj):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.numbers, b.numbers)


@pytest.mark.parametrize("fmt", ["lammps-dump-text", "cp2k", "vasp-xdatcar"])
def test_from_traj_refuses_other_formats(fmt):
    with pytest.raises(ValueError, match="xyz and extxyz only"):
        Trajectory.from_traj(XYZ, format=fmt)
