"""The port's ``trajectory`` module against ``amof_tpu.trajectory``:
``read_traj`` on every native format (sniffed and explicit), the LAMMPS
and CP2K trajectory readers, the density helpers, ``get_delta_pos``,
``ReducedTrajectory`` (the repo's ``example_reduced.*`` round trip and
``sample``) and the ASE bridge. Parsed arrays exactly equal, written
files byte-equal."""

import gzip
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import amof_tpu.trajectory as jtraj
import amof_tpu_torch.trajectory as ttraj
from amof_tpu_torch.core.frames import Trajectory as TTrajectory

from test_torch_io_formats import (CELL_HEADER, DUMP_ORTHO,
                                   DUMP_TRICLINIC_SCALED, POSCAR, XDATCAR,
                                   assert_frames_equal, cell_rows,
                                   rng_frames, xdatcar_npt)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = ROOT / "example_reduced"


def _write(path, text):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def _xyz_text(n_frames=4):
    """An extended-xyz trajectory as ``amof_tpu.io.xyz.write_xyz``
    writes it."""
    import tempfile

    from amof_tpu.io.xyz import write_xyz

    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "t.xyz"
        write_xyz(path, [p[1] for p in rng_frames(n_frames)])
        return path.read_text()


FORMAT_FILES = {
    "xyz": ("traj.xyz", None),
    "xyz_gz": ("traj.xyz.gz", None),
    "dump_by_name": ("run.lammpstrj", DUMP_ORTHO),
    "dump_by_content": ("unnamed.txt", DUMP_ORTHO),
    "dump_triclinic": ("dump.tilt", DUMP_TRICLINIC_SCALED),
    "poscar": ("POSCAR-zif", POSCAR),
    "xdatcar": ("XDATCAR", XDATCAR),
    "xdatcar_npt": ("XDATCAR_npt", None),
    "cif_by_content": ("structure.txt", None),
}


def format_file(case, tmp_path):
    name, text = FORMAT_FILES[case]
    if case.startswith("xyz"):
        text = _xyz_text()
    elif case == "xdatcar_npt":
        text = xdatcar_npt()
    elif case == "cif_by_content":
        from amof_tpu.io.cif import write_cif

        (_, j), = rng_frames(1, n=12, box=9.0)
        write_cif(tmp_path / "src.cif", j)
        text = (tmp_path / "src.cif").read_text()
    return _write(tmp_path / name, text)


SINGLE = ("poscar", "cif_by_content")  # one structure, no frame index


@pytest.mark.parametrize("case,index", [
    (case, index) for case in sorted(FORMAT_FILES)
    for index in ((None, ":") if case in SINGLE else (None, ":", 0, -1, "1:"))
])
def test_read_traj_matches(case, index, tmp_path):
    path = format_file(case, tmp_path)
    got = ttraj.read_traj(path, index)
    ref = jtraj.read_traj(path, index)
    assert isinstance(got, TTrajectory)
    assert_frames_equal(got.frames, ref.frames)
    assert_frames_equal(TTrajectory.from_traj(path, index).frames, ref.frames)


@pytest.mark.parametrize("fmt,name,text", [
    ("lammps-dump", "a.txt", DUMP_ORTHO),
    ("lammps-dump-text", "a.txt", DUMP_ORTHO),
    ("vasp", "a.txt", POSCAR),
    ("vasp-xdatcar", "a.txt", XDATCAR),
    ("extxyz", "a.txt", None),
])
def test_read_traj_explicit_format_matches(fmt, name, text, tmp_path):
    path = _write(tmp_path / name, text or _xyz_text())
    assert_frames_equal(ttraj.read_traj(path, format=fmt).frames,
                        jtraj.read_traj(path, format=fmt).frames)
    assert_frames_equal(TTrajectory.from_traj(path, format=fmt).frames,
                        jtraj.read_traj(path, format=fmt).frames)


def test_read_traj_specorder_and_data_kwargs_match(tmp_path):
    path = _write(tmp_path / "dump.x", DUMP_ORTHO)
    assert_frames_equal(
        ttraj.read_traj(path, 1, specorder=["C", "Zn"]).frames,
        jtraj.read_traj(path, 1, specorder=["C", "Zn"]).frames)
    data = tmp_path / "zif.data"
    data.write_text("t\n\n0.0 9.0 xlo xhi\n0.0 9.0 ylo yhi\n0.0 9.0 zlo zhi\n"
                    "\nMasses\n\n1 65.38\n\nAtoms\n\n1 1 1.0 2.0 3.0\n")
    assert_frames_equal(
        ttraj.read_traj(data, atom_style="atomic").frames,
        jtraj.read_traj(data, atom_style="atomic").frames)
    assert_frames_equal(ttraj.read_traj(str(data).replace(".data", "") +
                                        ".data", format="lammps-data",
                                        atom_style="atomic").frames,
                        jtraj.read_traj(data, atom_style="atomic").frames)


def test_unknown_format_raises_naming_ase(tmp_path):
    try:
        import ase  # noqa: F401

        pytest.skip("ase installed; the raise path is inactive")
    except ImportError:
        pass
    path = _write(tmp_path / "garbage.bin", "not a trajectory\nat all\n")
    for mod in (ttraj, jtraj):
        with pytest.raises(ValueError, match="ASE fallback"):
            mod.read_traj(path)
        with pytest.raises(ValueError, match="'pdb'"):
            mod.read_traj(path, format="pdb")
    with pytest.raises(ValueError, match="ASE fallback"):
        TTrajectory.from_traj(path, format="cp2k")


def test_ase_bridge_matches(tmp_path, monkeypatch):
    import types

    class FakeAtoms:
        def get_positions(self):
            return np.array([[0.0, 0.0, 0.0], [1.0, 1.5, 1.25]])

        def get_atomic_numbers(self):
            return np.array([30, 7])

        def get_cell(self):
            return np.eye(3) * 9.0

        def get_pbc(self):
            return np.array([True, False, False])

    calls = []
    ase_mod = types.ModuleType("ase")
    io_mod = types.ModuleType("ase.io")
    io_mod.read = lambda filename, index=None, **kw: (
        calls.append((filename, index, kw)) or FakeAtoms())
    ase_mod.io = io_mod
    monkeypatch.setitem(sys.modules, "ase", ase_mod)
    monkeypatch.setitem(sys.modules, "ase.io", io_mod)
    path = _write(tmp_path / "md.traj", "binary-ish placeholder")
    for fmt in ("traj", None):
        assert_frames_equal(ttraj.read_traj(path, format=fmt).frames,
                            jtraj.read_traj(path, format=fmt).frames)
    assert calls[0] == calls[1] and calls[0][2] == {"format": "traj"}


def cp2k_cell_file(tmp_path, n=6):
    path = tmp_path / "run.cell"
    path.write_text(CELL_HEADER + "".join(cell_rows(range(n), 3).values()))
    return path


@pytest.mark.parametrize("index", [None, slice(0, 4), slice(1, None, 2)])
def test_read_cp2k_traj_matches(index, tmp_path):
    from amof_tpu.io.xyz import write_xyz

    pairs = rng_frames(6, cell=False)
    xyz = tmp_path / "pos.xyz"
    write_xyz(xyz, [p[1] for p in pairs])
    cell = cp2k_cell_file(tmp_path)
    got = ttraj.read_cp2k_traj(xyz, cell, index=index)
    ref = jtraj.read_cp2k_traj(xyz, cell, index=index)
    assert_frames_equal(got, ref)
    assert all(f.pbc for f in got)


@pytest.mark.parametrize("with_cell", [False, True])
def test_read_lammps_traj_matches(with_cell, tmp_path):
    from amof_tpu.io.xyz import write_xyz

    pairs = rng_frames(5, cell=False)
    xyz = tmp_path / "dump.xyz"
    write_xyz(xyz, [p[1] for p in pairs])
    cell = [np.eye(3) * (9.0 + k) for k in range(4)] if with_cell else None
    assert_frames_equal(ttraj.read_lammps_traj(xyz, cell=cell),
                        jtraj.read_lammps_traj(xyz, cell=cell))


def test_density_helpers_and_delta_pos_match():
    pairs = rng_frames(4, n=30, seed=7, box=8.0)
    t = [p[0] for p in pairs]
    j = [p[1] for p in pairs]
    assert ttraj.get_density(t) == jtraj.get_density(j)
    assert ttraj.get_number_density(t) == jtraj.get_number_density(j)
    assert (ttraj.apply_to_traj(t, len, "mean")
            == jtraj.apply_to_traj(j, len, "mean"))
    for mod, traj in ((ttraj, t), (jtraj, j)):
        with pytest.raises(ValueError, match="unsupported aggregation"):
            mod.apply_to_traj(traj, len, "median")
    pos = np.stack([f.positions for f in t])
    cells = np.stack([f.cell for f in t])
    got = ttraj.get_delta_pos(pos, cells)
    ref = jtraj.get_delta_pos(pos, cells)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for kw in (dict(delta_Step=5, first_frame=2, number_of_frames=7),
               dict(first_frame=0, last_frame=10, delta_Step=2)):
        np.testing.assert_array_equal(ttraj.construct_step(**kw),
                                      jtraj.construct_step(**kw))


def test_reduced_trajectory_round_trip_matches(tmp_path):
    pytest.importorskip("pandas")
    got = ttraj.ReducedTrajectory.from_file(REDUCED)
    ref = jtraj.ReducedTrajectory.from_file(REDUCED)
    assert_frames_equal(got.trajectory, ref.trajectory)
    assert got.report_search.equals(ref.report_search)
    assert vars(got.symbols) == vars(ref.symbols)
    got.write_to_file(tmp_path / "t")
    ref.write_to_file(tmp_path / "j")
    for suffix in ("xyz", "report_search.csv", "symbols"):
        assert (tmp_path / f"t.{suffix}").read_bytes() == (
            tmp_path / f"j.{suffix}").read_bytes(), suffix
    back = ttraj.ReducedTrajectory.from_file(tmp_path / "t")
    assert_frames_equal(back.trajectory, ref.trajectory)
    assert back.report_search.equals(ref.report_search)
    lazy = ttraj.ReducedTrajectory.from_file(REDUCED, load_trajectory=False)
    assert lazy.trajectory == [] and lazy.report_search.equals(
        ref.report_search)


@pytest.mark.parametrize("sampling", [1, 2, 3])
def test_reduced_trajectory_sample_matches(sampling, tmp_path):
    pd = pytest.importorskip("pandas")
    pairs = rng_frames(6, n=4)
    rs = pd.DataFrame({
        "Step": np.arange(8) * 10,
        "in_reduced_trajectory": [True, False, True, True, True, False,
                                  True, True],
    }).set_index("Step")
    got = ttraj.ReducedTrajectory([p[0] for p in pairs], rs.copy())
    ref = jtraj.ReducedTrajectory([p[1] for p in pairs], rs.copy())
    got.sample(sampling)
    ref.sample(sampling)
    assert_frames_equal(got.trajectory, ref.trajectory)
    assert got.report_search.equals(ref.report_search)
    empty_t, empty_j = ttraj.ReducedTrajectory(), jtraj.ReducedTrajectory()
    assert empty_t.report_search.equals(empty_j.report_search)
    assert vars(empty_t.symbols) == vars(empty_j.symbols)


def test_no_pandas_for_the_modules_of_the_slice():
    """``trajectory``, ``io.cp2k`` and ``ring.core`` import, and xyz and
    LAMMPS files read, with pandas blocked; a DataFrame-building call
    then names pandas."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import amof_tpu_torch.trajectory as t\n"
        "import amof_tpu_torch.io.cp2k\n"
        "import amof_tpu_torch.ring.core as rc\n"
        f"t.read_traj({str(REDUCED) + '.xyz'!r})\n"
        "rc.Ring(max_search_depth=8)\n"
        "try:\n"
        "    t.ReducedTrajectory()\n"
        "except ImportError as e:\n"
        "    print('needs pandas:', e)\n"
        "assert 'pandas' not in [m for m in sys.modules\n"
        "                        if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout and "needs pandas" in proc.stdout

