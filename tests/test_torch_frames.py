"""The port's ``Trajectory.from_traj``: it dispatches on ``format``
through ``amof_tpu_torch.trajectory.read_traj`` (xyz and extxyz, LAMMPS
dumps, VASP XDATCAR, ...), and a format no native reader covers (CP2K
has none: its trajectories are xyz plus a ``.cell`` file) raises
``ValueError`` naming the ASE fallback instead of being read as xyz."""

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


FORMAT_FILES = {
    "lammps-dump-text": (
        "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n2\n"
        "ITEM: BOX BOUNDS pp pp pp\n0.0 10.0\n0.0 12.0\n0.0 14.0\n"
        "ITEM: ATOMS id type x y z\n2 1 1.0 2.0 3.0\n1 2 4.0 5.0 6.0\n"
        "ITEM: TIMESTEP\n50\nITEM: NUMBER OF ATOMS\n2\n"
        "ITEM: BOX BOUNDS xy xz yz pp pp pp\n0.0 11.0 1.0\n"
        "0.0 12.0 0.5\n0.0 14.0 0.0\n"
        "ITEM: ATOMS id type xs ys zs\n1 2 0.5 0.5 0.5\n2 1 0.25 0.0 0.0\n"),
    "vasp-xdatcar": (
        "toy\n1.0\n10.0 0.0 0.0\n0.0 10.0 0.0\n0.0 0.0 10.0\nZn N\n1 1\n"
        "Direct configuration=     1\n0.1 0.2 0.3\n0.4 0.5 0.6\n"
        "Direct configuration=     2\n0.15 0.25 0.35\n0.45 0.55 0.65\n"),
}


@pytest.mark.parametrize("fmt", ["lammps-dump-text", "cp2k", "vasp-xdatcar"])
def test_from_traj_refuses_other_formats(fmt, tmp_path):
    """LAMMPS dumps and XDATCARs read as ``amof_tpu.trajectory.read_traj``
    reads them; ``"cp2k"`` is no native format and raises (not read as
    xyz)."""
    if fmt == "cp2k":
        with pytest.raises(ValueError, match="ASE fallback"):
            Trajectory.from_traj(XYZ, format=fmt)
        return
    from amof_tpu.trajectory import read_traj

    path = tmp_path / "traj.txt"
    path.write_text(FORMAT_FILES[fmt])
    got = Trajectory.from_traj(path, format=fmt)
    ref = read_traj(path, format=fmt)
    assert len(got.traj) == len(ref.traj) == 2
    for a, b in zip(got.traj, ref.traj):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.numbers, b.numbers)
        assert np.array_equal(a.cell, b.cell)
        assert getattr(a, "step", None) == getattr(b, "step", None)
