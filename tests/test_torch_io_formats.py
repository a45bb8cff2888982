"""The port's readers and writers (``amof_tpu_torch.io``, ``files``,
``atom``, ``symbols``, ``ops.neighbors_host``) against ``amof_tpu`` on the
same file contents: parsed arrays exactly equal, written files
byte-equal. The file contents are those ``tests/test_io.py`` and
``tests/test_io_formats.py`` generate (the latter loaded by path)."""

import gzip
import importlib.util
import pathlib

import numpy as np
import pytest

import amof_tpu.atom as jatom
import amof_tpu.files.cp2k as jfcp2k
import amof_tpu.files.lammps as jflammps
import amof_tpu.files.operation as jop
import amof_tpu.io.cif as jcif
import amof_tpu.io.cp2k as jcp2k
import amof_tpu.io.lammps as jlammps
import amof_tpu.io.vasp as jvasp
import amof_tpu.io.xyz as jxyz
import amof_tpu.ops.neighbors_host as jnh
import amof_tpu.symbols as jsymbols
import amof_tpu.trajectory as jtraj
from amof_tpu.core.frames import Frame as JFrame
import amof_tpu_torch.atom as tatom
import amof_tpu_torch.files.cp2k as tfcp2k
import amof_tpu_torch.files.lammps as tflammps
import amof_tpu_torch.files.operation as top
import amof_tpu_torch.io.cif as tcif
import amof_tpu_torch.io.cp2k as tcp2k
import amof_tpu_torch.io.lammps as tlammps
import amof_tpu_torch.io.vasp as tvasp
import amof_tpu_torch.io.xyz as txyz
import amof_tpu_torch.ops.neighbors_host as tnh
import amof_tpu_torch.symbols as tsymbols
import amof_tpu_torch.trajectory as ttraj
from amof_tpu_torch.core.frames import Frame as TFrame

_SPEC = importlib.util.spec_from_file_location(
    "_io_formats_contents",
    pathlib.Path(__file__).resolve().parent / "test_io_formats.py")
_FORMATS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_FORMATS)
DUMP_ORTHO = _FORMATS.DUMP_ORTHO
DUMP_TRICLINIC_SCALED = _FORMATS.DUMP_TRICLINIC_SCALED
POSCAR = _FORMATS.POSCAR
XDATCAR = _FORMATS.XDATCAR


def assert_frames_equal(got, ref):
    """Same frame(s), exactly: positions, numbers, cell, pbc, step."""
    if isinstance(ref, JFrame):
        got, ref = [got], [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert isinstance(g, TFrame)
        np.testing.assert_array_equal(g.positions, r.positions)
        assert g.positions.dtype == r.positions.dtype
        np.testing.assert_array_equal(g.numbers, r.numbers)
        np.testing.assert_array_equal(g.cell, r.cell)
        assert g.pbc == r.pbc
        assert getattr(g, "step", None) == getattr(r, "step", None)


def pair(positions, numbers, cell=None, pbc=None):
    """The same frame in both packages."""
    kw = {} if pbc is None else {"pbc": pbc}
    return (TFrame(positions, numbers, cell, **kw),
            JFrame(positions, numbers, cell, **kw))


def rng_frames(n_frames=3, n=5, seed=0, box=7.5, cell=True):
    rng = np.random.default_rng(seed)
    numbers = rng.choice([30, 7, 6, 1], n)
    return [pair(rng.random((n, 3)) * box, numbers,
                 np.eye(3) * box if cell else None)
            for _ in range(n_frames)]


# --------------------------------------------------------------------------
# LAMMPS dumps and data files
# --------------------------------------------------------------------------

DUMP_CASES = {
    "ortho": ("dump.ortho", DUMP_ORTHO, {}),
    "ortho_index": ("dump.ortho", DUMP_ORTHO, {"index": 1}),
    "specorder": ("dump.spec", DUMP_ORTHO, {"specorder": ["C", "Zn"]}),
    "specorder_numbers": ("dump.spec", DUMP_ORTHO, {"specorder": [8, 30]}),
    "triclinic_scaled": ("tilt.lammpstrj", DUMP_TRICLINIC_SCALED, {}),
    "gzip_index": ("dump.gz", DUMP_ORTHO, {"index": "1:"}),
    "unwrapped": ("dump.u", DUMP_ORTHO.replace("x y z", "xu yu zu"), {}),
    "scaled_unwrapped": ("dump.su", DUMP_ORTHO.replace("x y z", "xsu ysu zsu"),
                         {}),
}


def _write(path, text):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", sorted(DUMP_CASES))
def test_lammps_dump_matches(case, tmp_path):
    name, text, kw = DUMP_CASES[case]
    path = _write(tmp_path / name, text)
    assert_frames_equal(tlammps.read_lammps_dump(path, **kw),
                        jlammps.read_lammps_dump(path, **kw))
    got = list(tlammps.iread_lammps_dump(path, kw.get("specorder")))
    assert_frames_equal(got, list(jlammps.iread_lammps_dump(
        path, kw.get("specorder"))))


@pytest.mark.parametrize("text,match", [
    (DUMP_ORTHO.replace("ITEM: NUMBER OF ATOMS", "ITEM: NATOMS", 1),
     "NUMBER OF ATOMS"),
    (DUMP_ORTHO.replace("x y z", "vx vy vz"), "position columns"),
    (DUMP_ORTHO.replace("id type", "id mol"), "neither"),
])
def test_lammps_dump_malformed_raises_alike(text, match, tmp_path):
    path = _write(tmp_path / "bad.dump", text)
    for reader in (tlammps.read_lammps_dump, jlammps.read_lammps_dump):
        with pytest.raises(ValueError, match=match):
            reader(path)


DATA = """LAMMPS data file

3 atoms
3 atom types

0.0 10.0 xlo xhi
-1.0 10.0 ylo yhi
0.5 10.0 zlo zhi
{tilt}
Masses

1 65.38
2 14.007 # N
3 12.011

Atoms # {style}

3 {row3}
1 {row1}
2 {row2}

Velocities

1 0 0 0
2 0 0 0
3 0 0 0
"""

DATA_ROWS = {
    "charge": ("1 0.5 1.0 2.0 3.0", "2 -0.5 4.0 5.0 6.0", "3 0.0 7.0 8.0 9.0"),
    "atomic": ("1 1.0 2.0 3.0", "2 4.0 5.0 6.0", "3 7.0 8.0 9.0"),
    "full": ("1 1 0.5 1.0 2.0 3.0", "1 2 0.0 4.0 5.0 6.0",
             "2 3 0.0 7.0 8.0 9.0"),
    "molecular": ("1 1 1.0 2.0 3.0", "1 2 4.0 5.0 6.0", "2 3 7.0 8.0 9.0"),
}


@pytest.mark.parametrize("style", sorted(DATA_ROWS))
@pytest.mark.parametrize("tilt", ["", "1.5 -0.5 0.25 xy xz yz\n"])
def test_lammps_data_matches(style, tilt, tmp_path):
    r1, r2, r3 = DATA_ROWS[style]
    path = tmp_path / "data.lmp"
    path.write_text(DATA.format(tilt=tilt, style=style, row1=r1, row2=r2,
                                row3=r3))
    got = tlammps.read_lammps_data(path, style)
    assert_frames_equal(got, jlammps.read_lammps_data(path, style))
    assert got.numbers.tolist() == [30, 7, 6]
    assert_frames_equal(ttraj.read_lammps_data(path, style),
                        jtraj.read_lammps_data(path, style))
    assert_frames_equal(
        ttraj.Trajectory.from_lammps_data(path, style).frames,
        jtraj.Trajectory.from_lammps_data(path, style).frames)


def test_lammps_data_errors_alike(tmp_path):
    path = tmp_path / "data.lmp"
    path.write_text("title\n\n1 atoms\n")
    for mod in (tlammps, jlammps):
        with pytest.raises(ValueError, match="no Atoms section"):
            mod.read_lammps_data(path, "charge")
        with pytest.raises(ValueError, match="atom_style"):
            mod.read_lammps_data(path, "ellipsoid")


def test_closest_atomic_number_matches():
    for mass in np.concatenate([np.linspace(0.5, 260.0, 2000),
                                [1.0, 12.011, 65.4, 1e4]]):
        assert (tlammps.closest_atomic_number(float(mass))
                == jlammps.closest_atomic_number(float(mass)))


def xyz_dump_with_duplicates():
    def frame(step, tag):
        return (f"2\nAtoms. Timestep: {step}\n"
                f"1 {tag} 0.0 0.0\n2 0.0 {tag} 0.0\n")

    return (frame(0, 1.0) + frame(10, 2.0) + frame(10, 9.0) + frame(20, 3.0)
            + frame(0, 8.0))


@pytest.mark.parametrize("shim", [False, True])
def test_remove_duplicate_timesteps_byte_equal(shim, tmp_path):
    a, b = tmp_path / "a.xyz", tmp_path / "b.xyz"
    a.write_text(xyz_dump_with_duplicates())
    b.write_text(xyz_dump_with_duplicates())
    (tflammps if shim else tlammps).remove_duplicate_timesteps(a)
    (jflammps if shim else jlammps).remove_duplicate_timesteps(b)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text().count("Atoms.") == 3


# --------------------------------------------------------------------------
# VASP
# --------------------------------------------------------------------------

POSCAR_CASES = {
    "direct": POSCAR,
    "cartesian_selective": POSCAR.replace(
        "Direct", "Selective dynamics\nCartesian"),
    "kartesian": POSCAR.replace("Direct", "Kartesian"),
    "negative_scale": POSCAR.replace("1.0\n", "-1500.0\n", 1),
    "gzip": POSCAR,
}


@pytest.mark.parametrize("case", sorted(POSCAR_CASES))
def test_poscar_matches(case, tmp_path):
    name = "POSCAR.gz" if case == "gzip" else "POSCAR"
    path = _write(tmp_path / name, POSCAR_CASES[case])
    assert_frames_equal(tvasp.read_poscar(path), jvasp.read_poscar(path))


def test_poscar_vasp4_raises_alike(tmp_path):
    path = _write(tmp_path / "POSCAR", POSCAR.replace("Zn N\n", ""))
    for mod in (tvasp, jvasp):
        with pytest.raises(ValueError, match="VASP-4"):
            mod.read_poscar(path)


def xdatcar_npt():
    header = XDATCAR.split("Direct configuration")[0]
    conf1 = "Direct configuration=     1\n0.1 0.2 0.3\n0.4 0.5 0.6\n"
    conf2 = "Direct configuration=     2\n0.15 0.25 0.35\n0.45 0.55 0.65\n"
    return header + conf1 + header.replace("10.0 0.0", "11.0 0.0", 1) + conf2


@pytest.mark.parametrize("case,index", [
    ("fixed", None), ("fixed", 1), ("fixed", "-1:"), ("npt", None),
    ("npt", 0)])
def test_xdatcar_matches(case, index, tmp_path):
    path = _write(tmp_path / "XDATCAR",
                  XDATCAR if case == "fixed" else xdatcar_npt())
    assert_frames_equal(tvasp.read_xdatcar(path, index),
                        jvasp.read_xdatcar(path, index))


# --------------------------------------------------------------------------
# CIF
# --------------------------------------------------------------------------

def triclinic_pair(n=24, seed=1):
    rng = np.random.default_rng(seed)
    cell = np.array([[12.0, 0.0, 0.0], [-2.5, 11.0, 0.0], [1.5, 2.0, 13.0]])
    frac = rng.random((n, 3)) * 1.4 - 0.2  # some outside the cell
    numbers = rng.choice([30, 7, 6, 1, 17], n)
    return pair(frac @ cell, numbers, cell)


@pytest.mark.parametrize("cubic", [True, False])
def test_cif_round_trip_byte_equal(cubic, tmp_path):
    if cubic:
        (t, j), = rng_frames(1, n=40, seed=2, box=15.0)
    else:
        t, j = triclinic_pair()
    tw, jw = tmp_path / "t.cif", tmp_path / "j.cif"
    tcif.write_cif(tw, t, data_name="amof")
    jcif.write_cif(jw, j, data_name="amof")
    assert tw.read_bytes() == jw.read_bytes()
    # the default data name is each package's own: only that line differs
    tcif.write_cif(tw, t)
    jcif.write_cif(jw, j)
    assert tw.read_text().splitlines()[0] == "data_amof_tpu_torch"
    assert tw.read_text().splitlines()[1:] == jw.read_text().splitlines()[1:]
    assert_frames_equal(tcif.read_cif(tw), jcif.read_cif(jw))
    assert_frames_equal(ttraj.read_traj(tw).frames, jtraj.read_traj(jw).frames)


CIF_FOREIGN = """# written by hand
data_foreign
_cell_length_a 10.0(2)
_cell_length_b 11.0
_cell_length_c 12.5
_cell_angle_alpha 90
_cell_angle_beta 95.5(1)
_cell_angle_gamma 90
_space_group_name_H-M_alt 'P1'
loop_
_atom_site_label
_atom_site_fract_x
_atom_site_fract_y
_atom_site_fract_z
Zn1 0.1 0.2 0.3
CL2 0.5(1) 0.25 0.75
n3 0.9 0.1e-1 0.5
"""


def test_cif_foreign_layout_matches(tmp_path):
    path = tmp_path / "foreign.cif"
    path.write_text(CIF_FOREIGN)
    got = tcif.read_cif(path)
    assert_frames_equal(got, jcif.read_cif(path))
    assert got.numbers.tolist() == [30, 17, 7]
    sym = tmp_path / "sym.cif"
    sym.write_text(CIF_FOREIGN.replace("'P1'", "'F m -3 m'"))
    for mod in (tcif, jcif):
        with pytest.raises(ValueError, match="only P1"):
            mod.read_cif(sym)


# --------------------------------------------------------------------------
# CP2K
# --------------------------------------------------------------------------

def cp2k_xyz(frames):
    out = []
    for step, tag in frames:
        out.append("2\n"
                   f" i = {step:8d}, time = {step * 0.5:12.3f}, E = -1.0\n"
                   f"O {tag} 0.0 0.0\nH 0.0 {tag} 0.0\n")
    return "".join(out)


CLEAN_XYZ_CASES = {
    "restart": "garbage line before\n" + cp2k_xyz(
        [(0, 1.0), (1, 2.0), (2, 3.0), (1, 9.0), (2, 9.0), (3, 4.0)]),
    "identity": cp2k_xyz([(0, 1.0), (1, 2.0)]),
    "preamble_only": "no frames here\nat all\n",
}


@pytest.mark.parametrize("case", sorted(CLEAN_XYZ_CASES))
@pytest.mark.parametrize("shim", [False, True])
def test_clean_xyz_byte_equal(case, shim, tmp_path):
    a, b = tmp_path / "a.xyz", tmp_path / "b.xyz"
    a.write_text(CLEAN_XYZ_CASES[case])
    b.write_text(CLEAN_XYZ_CASES[case])
    (tfcp2k if shim else tcp2k).clean_xyz(a)
    (jfcp2k if shim else jcp2k).clean_xyz(b)
    assert a.read_bytes() == b.read_bytes()


CELL_HEADER = ("#   Step   Time [fs]       Ax [Angstrom]       Ay [Angstrom]"
               "       Az [Angstrom]       Bx [Angstrom]       By [Angstrom]"
               "       Bz [Angstrom]       Cx [Angstrom]       Cy [Angstrom]"
               "       Cz [Angstrom]      Volume [Angstrom^3]\n")


def cell_rows(steps, seed=0):
    rng = np.random.default_rng(seed)
    rows = {}
    for s in steps:
        m = np.diag(15.0 + rng.random(3)) + 0.1 * rng.random((3, 3))
        rows[s] = (f"{s:8d} {s * 0.5:12.3f} "
                   + " ".join(f"{v:19.10f}" for v in m.ravel())
                   + f" {abs(np.linalg.det(m)):24.10f}\n")
    return rows


@pytest.mark.parametrize("shim", [False, True])
def test_clean_tabular_byte_equal(shim, tmp_path):
    rows = cell_rows(range(6))
    text = (CELL_HEADER + rows[0] + rows[1] + rows[2] + rows[3]
            + CELL_HEADER + rows[2] + rows[3] + rows[4] + rows[5])
    a, b = tmp_path / "a.cell", tmp_path / "b.cell"
    a.write_text(text)
    b.write_text(text)
    (tfcp2k if shim else tcp2k).clean_tabular(a)
    (jfcp2k if shim else jcp2k).clean_tabular(b)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text() == CELL_HEADER + "".join(rows[s] for s in range(6))


@pytest.mark.parametrize("shim", [False, True])
def test_read_tabular_matches(shim, tmp_path):
    pytest.importorskip("pandas")
    path = tmp_path / "run.cell"
    path.write_text(CELL_HEADER + "".join(cell_rows(range(7)).values()))
    got, gu = (tfcp2k if shim else tcp2k).read_tabular(path,
                                                       return_units=True)
    ref, ru = (jfcp2k if shim else jcp2k).read_tabular(path,
                                                       return_units=True)
    assert got.equals(ref) and gu == ru
    assert got.index.name == "Step" and ru["Volume"] == "Angstrom^3"
    assert tcp2k.read_tabular(path).equals(jcp2k.read_tabular(path))


@pytest.mark.parametrize("n_rows,index", [
    (7, None), (7, slice(0, 5)), (7, slice(2, None, 2)), (1, None)])
def test_read_cell_file_matches(n_rows, index, tmp_path):
    path = tmp_path / "run.cell"
    path.write_text(CELL_HEADER + "".join(cell_rows(range(n_rows)).values()))
    got = tcp2k.read_cell_file(path, index=index)
    ref = jcp2k.read_cell_file(path, index=index)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# xyz writer, sniffing, file operations, symbols
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cell", "no_cell", "gzip", "append",
                                  "single"])
def test_write_xyz_byte_equal(case, tmp_path):
    pairs = rng_frames(3, cell=case != "no_cell")
    t = [p[0] for p in pairs]
    j = [p[1] for p in pairs]
    suffix = ".xyz.gz" if case == "gzip" else ".xyz"
    tw, jw = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    if case == "single":
        t, j = t[0], j[0]
    txyz.write_xyz(tw, t)
    jxyz.write_xyz(jw, j)
    if case == "append":
        txyz.write_xyz(tw, t[:1], mode="a")
        jxyz.write_xyz(jw, j[:1], mode="a")
    if case == "gzip":
        with gzip.open(tw, "rb") as f, gzip.open(jw, "rb") as g:
            assert f.read() == g.read()
    else:
        assert tw.read_bytes() == jw.read_bytes()
    assert_frames_equal(txyz.read_xyz(tw, ":"), jxyz.read_xyz(jw, ":"))


SNIFF_NAMES = [
    "a.xyz", "a.extxyz", "a.xyz.gz", "run.lammpstrj", "x.dump",
    "dump.atom.gz", "zif.cif", "system.data", "POSCAR", "CONTCAR_3",
    "poscar.vasp", "XDATCAR", "XDATCAR.gz",
]
SNIFF_CONTENTS = {
    "dump": DUMP_ORTHO,
    "cif": "data_x\n_cell_length_a 5\n",
    "xyz": "3\ncomment\nZn 0 0 0\n",
    "unknown": "not a trajectory\nat all\n",
    "empty_first": "\nwhatever\n",
}


@pytest.mark.parametrize("name", SNIFF_NAMES)
def test_sniff_format_by_name_matches(name, tmp_path):
    path = tmp_path / name
    assert ttraj._sniff_format(path) == jtraj._sniff_format(path)


@pytest.mark.parametrize("case", sorted(SNIFF_CONTENTS))
def test_sniff_format_by_content_matches(case, tmp_path):
    path = _write(tmp_path / "unnamed.txt", SNIFF_CONTENTS[case])
    assert ttraj._sniff_format(path) == jtraj._sniff_format(path)


def test_file_operations_byte_equal(tmp_path):
    payload = bytes(range(256)) * 64
    for mod, sub in ((top, "t"), (jop, "j")):
        d = tmp_path / sub
        d.mkdir()
        (d / "f.bin").write_bytes(payload)
        mod.compress(str(d / "f.bin"))
        assert not (d / "f.bin").exists()
        with gzip.open(d / "f.bin.gz", "rb") as f:
            assert f.read() == payload
        mod.decompress(str(d / "f.bin"), remove=False)
        assert (d / "f.bin").read_bytes() == payload
        mod.compress(str(d / "f.bin"), remove_if_exists=True)
        mod.decompress(str(d / "f.bin"))
        assert not (d / "f.bin.gz").exists()
        (d / "a").write_text("1")
        (d / "b").write_text("2")
        mod.concatenate([d / "a", d / "b", d / "f.bin"], d / "out")
    assert (tmp_path / "t" / "out").read_bytes() == (
        tmp_path / "j" / "out").read_bytes()


@pytest.mark.parametrize("names", [["Zn", "Im"], ["Im", "mIm", "Fr", "Zn"],
                                   ["Ra", "ImCycle"]])
def test_dummy_symbols_match(names, tmp_path):
    t, j = tsymbols.DummySymbols(names), jsymbols.DummySymbols(names)
    assert t.from_name_to_symbol == j.from_name_to_symbol
    assert t.available_chemical_symbols == j.available_chemical_symbols
    assert str(t) == str(j)
    t.write_to_file(tmp_path / "t")
    j.write_to_file(tmp_path / "j")
    assert (tmp_path / "t.symbols").read_bytes() == (
        tmp_path / "j.symbols").read_bytes()
    tb = tsymbols.DummySymbols.from_file(tmp_path / "t")
    jb = jsymbols.DummySymbols.from_file(tmp_path / "j")
    assert vars(tb) == vars(jb)
    tb.add_names(["Other"])
    jb.add_names(["Other"])
    assert tb.get_symbol("Other") == jb.get_symbol("Other")
    assert tb.get_name(tb.get_symbol("Other")) == "Other"


# --------------------------------------------------------------------------
# Host pair search and atom utilities
# --------------------------------------------------------------------------

def glass(n, box, seed, triclinic=False):
    rng = np.random.default_rng(seed)
    cell = np.eye(3) * box
    if triclinic:
        cell[1, 0], cell[2, 0], cell[2, 1] = 0.2 * box, -0.1 * box, 0.15 * box
    numbers = rng.choice([30, 7, 6, 1], n)
    return rng.random((n, 3)) @ cell, numbers, cell


@pytest.mark.parametrize("force", [None, "legacy", "celllist"])
@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("matrix", [False, True])
def test_neighbor_pairs_match(force, triclinic, matrix):
    pos, numbers, cell = glass(300, 16.0, 4, triclinic)
    cutoff = (tnh.cutoff_dict_to_matrix({(30, 7): 2.6, (6, 6): 1.8,
                                         (6, 7): 2.0, (1, 6): 1.3})
              if matrix else 2.4)
    kw = dict(species=numbers if matrix else None, _force=force)
    got = tnh.neighbor_pairs(pos, cell, True, cutoff, **kw)
    ref = jnh.neighbor_pairs(pos, cell, True, cutoff, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert len(got[0]) > 0


def test_neighbor_pairs_edge_cases_match():
    pos, numbers, cell = glass(40, 12.0, 5)
    for args in [(pos, cell, False, 3.0), (pos, np.zeros((3, 3)), True, 3.0),
                 (pos[:0], cell, True, 3.0), (pos, cell, True, 0.5)]:
        for g, r in zip(tnh.neighbor_pairs(*args), jnh.neighbor_pairs(*args)):
            np.testing.assert_array_equal(g, r)
    for mod in (tnh, jnh):
        with pytest.raises(ValueError, match="species required"):
            mod.neighbor_pairs(pos, cell, True, np.ones((119, 119)))
    np.testing.assert_array_equal(
        tnh.cutoff_dict_to_matrix({(30, 7): 2.5}, max_z=40),
        jnh.cutoff_dict_to_matrix({(30, 7): 2.5}, max_z=40))


def test_atom_utilities_match():
    pos, numbers, cell = glass(120, 11.0, 6, triclinic=True)
    t, j = pair(pos, numbers, cell)
    for name in ("get_density", "get_number_density", "get_total_mass",
                 "get_atomic_numbers_unique"):
        assert getattr(tatom, name)(t) == getattr(jatom, name)(j), name
    for z in (None, 30, 1, 99):
        np.testing.assert_array_equal(tatom.select_species_positions(t, z),
                                      jatom.select_species_positions(j, z))
    spec = {"Zn-N": 2.6, "C-N": 2.0, "H-C": 1.3}
    for sort_pair in (False, True):
        assert (tatom.format_cutoff(spec, sort_pair=sort_pair)
                == jatom.format_cutoff(spec, sort_pair=sort_pair))
    for mod in (tatom, jatom):
        with pytest.raises(ValueError, match="unsupported format"):
            mod.format_cutoff(spec, format="pymatgen")
    cd = tatom.format_cutoff(spec)
    assert tatom.get_neighborlist(t, cd) == jatom.get_neighborlist(j, cd)
