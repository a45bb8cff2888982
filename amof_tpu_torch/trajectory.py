"""
User-facing trajectory module: readers, step construction, displacement
decomposition, ReducedTrajectory.

API parity with amof/trajectory.py — ``read_lammps_traj`` :193,
``read_cp2k_traj`` :208, ``read_lammps_data`` :186, ``construct_step``
:244, ``get_delta_pos`` :285, ``get_density``/``get_number_density``
:236-242, ``ReducedTrajectory`` :120-184 — implemented on top of
amof_tpu_torch's own I/O (no ASE dependency). pandas is imported only by
``ReducedTrajectory``, inside its methods.
"""

from __future__ import annotations

import logging
import pathlib

import numpy as np

import amof_tpu_torch.atom
import amof_tpu_torch.files.path as ampath
import amof_tpu_torch.symbols
from amof_tpu_torch.core.cellmath import wrap_positions
from amof_tpu_torch.core.frames import Frame, FrameBatch, Trajectory, as_frame_batch  # noqa: F401
from amof_tpu_torch.core.step import construct_step  # noqa: F401  (re-export)
from amof_tpu_torch.io import cp2k as _cp2k
from amof_tpu_torch.io import lammps as _lammps
from amof_tpu_torch.io import xyz as _xyz

logger = logging.getLogger(__name__)


def _sniff_format(filename) -> str:
    """Guess the trajectory format from the filename, then content."""
    name = pathlib.Path(str(filename)).name
    stem = name[:-3] if name.endswith(".gz") else name
    suffix = pathlib.Path(stem).suffix.lower()
    if suffix in (".xyz", ".extxyz"):
        return "xyz"
    if suffix in (".lammpstrj", ".dump") or stem.startswith("dump"):
        return "lammps-dump-text"
    if suffix == ".cif":
        return "cif"
    if suffix == ".data":
        return "lammps-data"
    upper = stem.upper()
    if upper.startswith(("POSCAR", "CONTCAR")):
        return "vasp"
    if upper.startswith("XDATCAR"):
        return "vasp-xdatcar"
    with _xyz._open(filename) as f:
        head = [f.readline() for _ in range(2)]
    first = head[0].strip()
    if first.startswith("ITEM: TIMESTEP"):
        return "lammps-dump-text"
    if first.startswith("data_"):
        return "cif"
    try:
        int(first.split()[0])
        return "xyz"
    except (ValueError, IndexError):
        return "ase"  # unknown to the native readers: ASE fallback


def read_traj(filename, index=None, format=None, unzip=False, **kwargs):
    """Read a trajectory file into a Trajectory.

    The general-format equivalent of the reference's ASE-backed
    ``Trajectory.from_traj`` (amof/trajectory.py:38-60): xyz/extxyz,
    native LAMMPS dumps (``dump atom``/``dump custom``), VASP
    POSCAR/CONTCAR/XDATCAR, CIF, and LAMMPS data files, each with
    ASE-style ``index`` selection. ``unzip`` is accepted for API
    compatibility — gzip is always handled transparently. Extra kwargs
    (e.g. ``specorder`` for LAMMPS dumps, ``atom_style`` for data
    files) pass through to the format reader.
    """
    del unzip  # gzip is transparent in every reader
    logger.info("Read trajectory %s", filename)
    fmt = format or _sniff_format(filename)
    fmt = {"extxyz": "xyz", "lammps-dump": "lammps-dump-text"}.get(fmt, fmt)
    index = index if index is not None else ":"
    if fmt == "xyz":
        frames = _xyz.read_xyz(filename, index)
    elif fmt == "lammps-dump-text":
        frames = _lammps.read_lammps_dump(filename, index, **kwargs)
    elif fmt == "vasp":
        from amof_tpu_torch.io import vasp as _vasp

        frames = _vasp.read_poscar(filename)
    elif fmt == "vasp-xdatcar":
        from amof_tpu_torch.io import vasp as _vasp

        frames = _vasp.read_xdatcar(filename, index)
    elif fmt == "cif":
        from amof_tpu_torch.io.cif import read_cif

        frames = read_cif(filename)
    elif fmt == "lammps-data":
        frames = _lammps.read_lammps_data(
            filename, kwargs.pop("atom_style", "charge")
        )
    else:
        # any other format rides ase.io.read when ase is installed —
        # the full breadth of the reference's ASE-backed ingestion
        # (amof/trajectory.py:38-60: .traj binaries, PDB, DCD, ...)
        frames = _read_via_ase(
            filename, index, None if fmt == "ase" else fmt, **kwargs
        )
    if isinstance(frames, Frame):
        frames = [frames]
    return Trajectory(frames)


def _read_via_ase(filename, index, fmt, **kwargs):
    """Optional ASE ingestion bridge: formats the native readers do
    not cover (.traj, PDB, DCD, ...) are read with ``ase.io.read``
    when ase is installed; otherwise raise naming the format (parity
    breadth: amof/trajectory.py:38-60)."""
    try:
        import ase.io
    except ImportError:
        raise ValueError(
            f"cannot read {filename!r}"
            + (f" (format {fmt!r})" if fmt else "")
            + ": not one of the native formats (xyz/extxyz, LAMMPS "
            "dump/data, VASP POSCAR/XDATCAR, CIF, CP2K) and the "
            "optional ASE fallback is unavailable — pip install ase, "
            "or pass format= for a native reader"
        ) from None
    images = ase.io.read(
        str(filename), index=index, **(
            {"format": fmt, **kwargs} if fmt else kwargs
        )
    )
    if not isinstance(images, (list, tuple)):
        images = [images]
    return [
        Frame(
            a.get_positions(), a.get_atomic_numbers(),
            np.asarray(a.get_cell()), pbc=bool(np.any(a.get_pbc())),
        )
        for a in images
    ]


def read_lammps_data(filename, atom_style):
    """Single-frame trajectory from a LAMMPS data file
    (parity: amof/trajectory.py:186-191)."""
    return [_lammps.read_lammps_data(filename, atom_style)]


def read_lammps_traj(path_to_xyz, index=None, cell=None, unzip_xyz=False):
    """Read a LAMMPS xyz dump, optionally attaching per-frame cells
    (parity: amof/trajectory.py:193-205)."""
    traj = read_traj(path_to_xyz, index, format="xyz", unzip=unzip_xyz)
    if cell is not None:
        traj.set_cell(cell, set_pbc=True)
    return traj.get_traj()


def read_cp2k_traj(path_to_xyz, path_to_cell, index=None, unzip_xyz=False):
    """Read a CP2K xyz + .cell file pair
    (parity: amof/trajectory.py:208-228)."""
    traj = read_traj(path_to_xyz, index, format="xyz", unzip=unzip_xyz)
    cell = _cp2k.read_cell_file(path_to_cell, index=index)
    traj.set_cell(cell, set_pbc=True)
    return traj.get_traj()


def apply_to_traj(trajectory, function, how):
    """Apply ``function`` to every frame and aggregate
    (parity: amof/trajectory.py:231-234)."""
    if how == "mean":
        return np.mean([function(frame) for frame in trajectory])
    raise ValueError(f"unsupported aggregation {how!r}")


def get_density(trajectory, how="mean"):
    """Mean mass density (kg/L) of a trajectory."""
    return apply_to_traj(trajectory, amof_tpu_torch.atom.get_density, how)


def get_number_density(trajectory, how="mean"):
    """Mean number density (Å^-3) of a trajectory."""
    return apply_to_traj(trajectory, amof_tpu_torch.atom.get_number_density, how)


def get_delta_pos(pos, cell):
    """Decompose a position trajectory into minimum-image displacements.

    delta_pos[0] holds the initial positions; delta_pos[k] (k>=1) is the
    frame-(k-1)->frame-k displacement wrapped into the cell around the
    origin (parity: amof/trajectory.py:285-303). Summing delta_pos[0..k]
    reconstructs unwrapped positions.
    """
    delta_pos = [np.asarray(pos[0], dtype=np.float64)]
    for k in range(len(pos) - 1):
        delta_pos.append(
            wrap_positions(pos[k + 1] - pos[k], cell[k], center=(0.0, 0.0, 0.0))
        )
    return delta_pos


class ReducedTrajectory:
    """Coarse-grained trajectory: frames + report_search + DummySymbols.

    Round-trips as .xyz + .report_search.csv + .symbols files
    (parity: amof/trajectory.py:120-184).
    """

    def __init__(self, trajectory=None, report_search=None, symbols=None):
        if report_search is None:
            import pandas as pd

            report_search = pd.DataFrame({"Step": np.empty([0])})
        self.trajectory = [] if trajectory is None else trajectory
        self.report_search = report_search
        self.symbols = (
            amof_tpu_torch.symbols.DummySymbols() if symbols is None else symbols
        )

    @classmethod
    def from_file(cls, filename, sampling=1, load_trajectory=True):
        """Load from ``filename`` (without the final suffixes)."""
        import pandas as pd

        if load_trajectory:
            logger.info("Read reduced trajectory %s", pathlib.Path(filename).name)
            trajectory = _xyz.read_xyz(ampath.append_suffix(filename, "xyz"), ":")
        else:
            trajectory = []
        report_search = pd.read_csv(
            ampath.append_suffix(filename, "report_search.csv"), index_col=0
        )
        symbols = amof_tpu_torch.symbols.DummySymbols.from_file(filename)
        new = cls(trajectory, report_search, symbols)
        if sampling != 1:
            new.sample(sampling)
        return new

    def write_to_file(self, filename):
        self.report_search.to_csv(
            ampath.append_suffix(filename, "report_search.csv")
        )
        _xyz.write_xyz(ampath.append_suffix(filename, "xyz"), self.trajectory)
        self.symbols.write_to_file(filename)

    def sample(self, sampling):
        """Keep every ``sampling``-th frame among those flagged
        in_reduced_trajectory (reference rounding semantics,
        amof/trajectory.py:168-184)."""
        if len(self.report_search) != 0:
            rs_traj = self.report_search[
                self.report_search["in_reduced_trajectory"] == True  # noqa: E712
            ]
            in_traj_sampling = round(
                sampling * len(rs_traj) / len(self.report_search)
            )
            if in_traj_sampling != 0:
                self.trajectory = self.trajectory[::in_traj_sampling]
                self.report_search = rs_traj[::in_traj_sampling]
