"""
Core trajectory data structures.

Frames are arrays, not objects. The container the analyses consume is
``FrameBatch``: host numpy arrays ``positions f32[F, N, 3]``,
``cell f32[F, 3, 3]``, ``species i32[N]`` and ``step i32[F]``, which
the fused step uploads to its device once.

``Frame`` is the host-side, ASE-``Atoms``-compatible view used by the I/O
adapters and the (host) coordination-search code. It mirrors the subset of
the ASE API the reference actually exercises (get_positions /
get_atomic_numbers / get_cell / get_masses / get_center_of_mass /
get_angles(mic=True) / wrap / translate / get_volume — see
amof/atom.py, amof/msd.py:218-242, amof/bad.py:100).

Species are static across a trajectory — the reference itself assumes this
by reading them from frame 0 only (amof/rdf.py:71, amof/cn.py:52).
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Union

import numpy as np

from amof_tpu_torch.core import cellmath
from amof_tpu_torch.data import elements


class Frame:
    """A single configuration: positions, atomic numbers, periodic cell."""

    def __init__(self, positions, numbers, cell=None, pbc=True):
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
        self.numbers = np.asarray(numbers, dtype=np.int64).reshape(-1)
        if len(self.positions) != len(self.numbers):
            raise ValueError("positions and numbers length mismatch")
        self.cell = (
            np.zeros((3, 3)) if cell is None else cellmath.cell_from_any(cell)
        )
        self.pbc = bool(pbc)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_symbols(cls, symbols: Sequence[str], positions, cell=None, pbc=True):
        numbers = [elements.atomic_numbers[s] for s in symbols]
        return cls(positions, numbers, cell, pbc)

    def copy(self) -> "Frame":
        return Frame(self.positions.copy(), self.numbers.copy(), self.cell.copy(), self.pbc)

    # -- ASE-compatible accessors -------------------------------------------
    def __len__(self):
        return len(self.numbers)

    def get_global_number_of_atoms(self) -> int:
        return len(self.numbers)

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, positions):
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)

    def get_atomic_numbers(self) -> np.ndarray:
        return self.numbers.copy()

    def set_atomic_numbers(self, numbers):
        self.numbers = np.asarray(numbers, dtype=np.int64).reshape(-1)

    def get_chemical_symbols(self) -> List[str]:
        return [elements.chemical_symbols[z] for z in self.numbers]

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def set_cell(self, cell):
        self.cell = cellmath.cell_from_any(cell)

    def set_pbc(self, pbc):
        self.pbc = bool(pbc)

    def get_cell_lengths_and_angles(self) -> np.ndarray:
        return cellmath.cell_lengths_and_angles(self.cell)

    def get_volume(self) -> float:
        v = cellmath.volume(self.cell)
        if v == 0.0:
            raise ValueError("frame has no cell; volume undefined")
        return v

    def get_masses(self) -> np.ndarray:
        return elements.mass_of(self.numbers)

    def get_center_of_mass(self) -> np.ndarray:
        m = self.get_masses()
        return (m[:, None] * self.positions).sum(axis=0) / m.sum()

    def translate(self, displacement):
        self.positions = self.positions + np.asarray(displacement, dtype=np.float64)

    def wrap(self, center=(0.5, 0.5, 0.5)):
        """Wrap positions into the cell (parity: atom.wrap() at
        amof/coordination/reduce.py:95)."""
        if self.pbc and cellmath.volume(self.cell) > 0:
            self.positions = cellmath.wrap_positions(self.positions, self.cell, center)

    def get_angles(self, indices, mic: bool = True) -> np.ndarray:
        """Angles (degrees) at the middle atom of each [i, j, k] triple.

        Minimum-image convention applied to both arms when mic=True —
        the semantics the BAD module relies on (amof/bad.py:100).
        """
        indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        v1 = self.positions[indices[:, 0]] - self.positions[indices[:, 1]]
        v2 = self.positions[indices[:, 2]] - self.positions[indices[:, 1]]
        if mic and self.pbc:
            v1 = cellmath.min_image_delta(v1, self.cell)
            v2 = cellmath.min_image_delta(v2, self.cell)
        cosang = np.sum(v1 * v2, axis=1) / (
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1)
        )
        return np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))

    def formula_counts(self) -> dict:
        """{symbol: count} — the reference reads this off
        ``atom.symbols.formula._count`` (amof/msd.py:263)."""
        syms, counts = np.unique(self.get_chemical_symbols(), return_counts=True)
        return {str(s): int(c) for s, c in zip(syms, counts)}

    def __repr__(self):
        return f"Frame(n_atoms={len(self)}, pbc={self.pbc})"


class FrameBatch(NamedTuple):
    """Trajectory batch as host arrays.

    positions: f32[F, N, 3] cartesian coordinates
    cell:      f32[F, 3, 3] per-frame lattice (row vectors)
    species:   i32[N]       atomic numbers, static across frames
    step:      i32[F]       simulation step labels
    """

    positions: "np.ndarray"
    cell: "np.ndarray"
    species: "np.ndarray"
    step: "np.ndarray"

    @property
    def num_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def num_atoms(self) -> int:
        return self.positions.shape[1]

    @classmethod
    def from_frames(cls, frames: Sequence[Frame], step=None, dtype=np.float32):
        if len(frames) == 0:
            raise ValueError("empty trajectory")
        n = len(frames[0])
        for f in frames:
            if len(f) != n:
                raise ValueError("all frames must have the same atom count")
            if not np.array_equal(f.numbers, frames[0].numbers):
                raise ValueError(
                    "species must be identical across frames (the reference "
                    "makes the same assumption by reading them from frame 0, "
                    "amof/rdf.py:71)"
                )
        species = frames[0].numbers.astype(np.int32)
        positions = np.stack([f.positions for f in frames]).astype(dtype)
        cell = np.stack([f.cell for f in frames]).astype(dtype)
        if step is None:
            step = np.arange(len(frames), dtype=np.int32)
        return cls(positions, cell, species, np.asarray(step, dtype=np.int32))

    def to_frames(self) -> List[Frame]:
        species = np.asarray(self.species)
        return [
            Frame(np.asarray(self.positions[i], dtype=np.float64), species,
                  np.asarray(self.cell[i], dtype=np.float64))
            for i in range(self.num_frames)
        ]

    def frame(self, i: int) -> Frame:
        return Frame(
            np.asarray(self.positions[i], dtype=np.float64),
            np.asarray(self.species),
            np.asarray(self.cell[i], dtype=np.float64),
        )


class Trajectory:
    """Host-side list of frames, the reference's ``Trajectory`` wrapper
    (parity: amof/trajectory.py:27-117)."""

    def __init__(self, frames: Iterable[Frame] = ()):
        self.frames: List[Frame] = list(frames)

    @property
    def traj(self) -> List[Frame]:
        """Reference attribute name for the frame list (trajectory.py:34)."""
        return self.frames

    @classmethod
    def from_traj(cls, filename, index=None, format=None, unzip=False):
        """Read a trajectory file (parity: amof/trajectory.py:38-60)
        through ``amof_tpu_torch.trajectory.read_traj``: ``format`` is
        honoured (sniffed from the name and content when None), gzip is
        handled transparently regardless of ``unzip``."""
        from amof_tpu_torch.trajectory import read_traj

        return cls(read_traj(filename, index, format=format,
                             unzip=unzip).frames)

    @classmethod
    def from_lammps_data(cls, filename, atom_style):
        """Single-frame trajectory from a LAMMPS data file
        (parity: amof/trajectory.py:62-74)."""
        from amof_tpu_torch.io.lammps import read_lammps_data

        return cls([read_lammps_data(filename, atom_style)])

    @staticmethod
    def get_index_closest(my_list, my_number):
        """Index of the closest value in a sorted list
        (parity: amof/trajectory.py:76-94)."""
        import bisect

        pos = bisect.bisect_left(my_list, my_number)
        if pos == 0:
            return my_list[0]
        if pos == len(my_list):
            return my_list[-1]
        before, after = my_list[pos - 1], my_list[pos]
        return pos if after - my_number < my_number - before else pos - 1

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Trajectory(self.frames[i])
        return self.frames[i]

    def __iter__(self):
        return iter(self.frames)

    def append(self, frame: Frame):
        self.frames.append(frame)

    def set_cell(self, cell, set_pbc: bool = True, fit_size: bool = True):
        """Attach per-frame cells (parity: amof/trajectory.py:96-114,
        including the size-mismatch truncation behavior)."""
        cell = list(cell)
        if fit_size and len(self.frames) != len(cell):
            if len(self.frames) > len(cell):
                self.frames = self.frames[: len(cell)]
            else:
                cell = cell[: len(self.frames)]
        for frame, c in zip(self.frames, cell):
            frame.set_cell(c)
            if set_pbc:
                frame.set_pbc(True)

    def get_traj(self) -> List[Frame]:
        return self.frames

    def to_batch(self, step=None, dtype=np.float32) -> FrameBatch:
        return FrameBatch.from_frames(self.frames, step=step, dtype=dtype)


TrajectoryLike = Union[FrameBatch, Trajectory, Sequence[Frame]]


def as_frame_batch(traj: TrajectoryLike, dtype=np.float32) -> FrameBatch:
    """Normalize any accepted trajectory form to a FrameBatch."""
    if isinstance(traj, FrameBatch):
        return traj
    if isinstance(traj, Trajectory):
        return traj.to_batch(dtype=dtype)
    return FrameBatch.from_frames(list(traj), dtype=dtype)


def as_frames(traj: TrajectoryLike) -> List[Frame]:
    """Normalize any accepted trajectory form to a list of Frames."""
    if isinstance(traj, FrameBatch):
        return traj.to_frames()
    if isinstance(traj, Trajectory):
        return traj.frames
    return list(traj)
