"""
Radial distribution functions on the card.

Counterpart of ``amof_tpu/rdf.py`` (API parity with amof/rdf.py): ``Rdf``
with ``from_trajectory(traj, dr=0.01, rmax='half_cell', device='cuda')``,
``.data`` ("r", "X-X", every ordered "A-B" partial, "A-X" row sums),
``write_to_file``/``from_file`` with the '.rdf' feather suffix, the
``rmax='half_cell'`` rule (half the smallest perpendicular cell
*width* over the frames, where the minimum image by rounding stops being
exact; the reference takes half the smallest *length*, the same number
on a diagonal cell and past that domain on a sheared one),
``bins = int(rmax // dr)`` and exact shell volumes; the
deprecated RDF-integral ``CoordinationNumber``,
``get_coordination_number`` and ``RdfPlotter``.

The pair pass is the hand-written histogram kernel: kernel #1 on the
species-blocked layout, kernel #2 (``pad_atoms`` order) when blocking
would pad the atom count past 1.5x; the RDF-integral CN always takes #2,
at its fine default dr (0.0001 A: global-atomic mode). Counts are
volume-weighted per frame and summed in float64 on the device.

Normalization (asap3-compatible, as ``amof_tpu``):
    g_AB(r_k) = C_AB(k) * V / (F * N_A * N_tot * v_shell(k))

The device work lives in pandas-free functions (``rdf_columns``,
``rdf_cn_columns``) that return ordered numpy columns; the classes only
wrap them in a DataFrame (pandas is imported inside the classes, so the
package imports without it).
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.integrate
import torch

import amof_tpu_torch.files.path
from amof_tpu_torch.core.cellmath import half_cell
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.core.step import construct_step
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import frame_table, pair_engine
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)


def shell_volumes(bins: int, dr: float) -> np.ndarray:
    """Exact spherical shell volumes 4pi/3((r+dr)^3 - r^3)."""
    edges = np.arange(bins + 1) * dr
    return 4.0 * np.pi / 3.0 * (edges[1:] ** 3 - edges[:-1] ** 3)


def rdf_table(counts, species, unique, n_frames: int, dr: float, bins: int):
    """Ordered g(r) columns {name: float64 array} from volume-weighted
    ordered-pair counts [S, S, bins] (amof_tpu/rdf.py:152-170)."""
    counts = np.asarray(counts, dtype=np.float64)
    species = np.asarray(species)
    n_atoms = len(species)
    v_shell = shell_volumes(bins, dr)
    n_per_species = np.array([(species == z).sum() for z in unique],
                             dtype=np.float64)
    sym = elements.symbol_of
    cols = {"r": np.arange(bins) * dr}
    # total X-X: all pairs, normalized with N_sel = N_tot
    cols["X-X"] = counts.sum(axis=(0, 1)) / (
        n_frames * n_atoms * n_atoms * v_shell)
    partial = {}
    for i, za in enumerate(unique):
        for j, zb in enumerate(unique):
            g = counts[i, j] / (n_frames * n_per_species[i] * n_atoms * v_shell)
            partial[(i, j)] = g
            cols[f"{sym(za)}-{sym(zb)}"] = g
    for i, za in enumerate(unique):
        cols[f"{sym(za)}-X"] = sum(partial[(i, j)]
                                   for j in range(len(unique)))
    return cols


def _tensor(a, dev, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def rdf_columns(trajectory, dr=0.01, rmax="half_cell", device="cuda"):
    """The RDF of a trajectory as ordered numpy columns (what
    ``Rdf.from_trajectory`` puts in ``.data``)."""
    dev = resolve_device(device)
    batch = as_frame_batch(trajectory)
    species = np.asarray(batch.species)
    unique, z_to_idx = frame_table.species_table(species)

    cells = np.asarray(batch.cell, dtype=np.float64)
    rmax_half_cell = half_cell(cells)
    if rmax == "half_cell":
        rmax = rmax_half_cell
    elif rmax > rmax_half_cell:
        logger.info(
            "Specified rmax %s is larger than half cell; will use half_cell "
            "rmax", rmax,
        )
        rmax = rmax_half_cell
    logger.info("Start computing rdf for %s frames with dr = %s and rmax = %s",
                batch.num_frames, dr, rmax)
    bins = int(rmax // dr)
    volumes = np.abs(np.linalg.det(cells)).astype(np.float32)

    # species-blocked layout (kernel #1) unless per-species tile padding
    # would inflate the pair count (small systems: kernel #2)
    positions, species_idx, blocked = frame_table.atom_layout(
        batch.positions, z_to_idx[species], block=256)
    cells32 = np.asarray(batch.cell, dtype=np.float32)
    ortho = bool(np.all(cells32 == cells32 * np.eye(3, dtype=np.float32)))
    counts = pair_engine.trajectory_rdf_counts(
        _tensor(positions, dev), _tensor(cells32, dev),
        _tensor(species_idx, dev, np.int32), float(dr), len(unique), bins,
        blocked=blocked, ortho=ortho, frame_weights=_tensor(volumes, dev),
    )  # volume-weighted counts [S, S, bins]
    return rdf_table(counts.cpu().numpy(), species, unique, batch.num_frames,
                     dr, bins)


class Rdf:
    """Total + all-pairs partial g(r) over a trajectory."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"r": np.empty([0])})

    @classmethod
    def from_trajectory(cls, trajectory, dr=0.01, rmax="half_cell",
                        device="cuda"):
        """Compute the RDF of a trajectory on ``device``.

        Args:
            trajectory: Trajectory / list of Frames / FrameBatch.
            dr: bin width in Å.
            rmax: float in Å or 'half_cell' (half the smallest
                perpendicular cell width over all frames; larger values
                are clamped to it).
        """
        rdf_class = cls()
        rdf_class.compute_rdf(trajectory, dr, rmax, device)
        return rdf_class

    @classmethod
    def from_rdf(cls, *args):
        logger.exception("from_rdf is deprecated, use from_file instead")

    @classmethod
    def from_file(cls, path_to_rdf):
        rdf_class = cls()
        rdf_class.read_rdf_file(path_to_rdf)
        return rdf_class

    def compute_rdf(self, trajectory, dr, rmax, device="cuda"):
        import pandas as pd

        self.data = pd.DataFrame(rdf_columns(trajectory, dr, rmax, device))

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "rdf")
        self.data.to_feather(filename)

    def read_rdf_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "rdf")
        self.data = pd.read_feather(path_to_data)

    def get_coordination_number(self, nn_set, cutoff, density):
        """RDF-integral coordination number for pair column ``nn_set``."""
        return get_coordination_number(
            self.data["r"], self.data[nn_set], cutoff, density
        )


def rdf_cn_columns(trajectory, nb_set_and_cutoff, step, dr=0.0001,
                   device="cuda"):
    """Per-frame RDF-integral coordination numbers as ordered numpy
    columns ("Step", then one per pair spec): kernel #2 on every frame."""
    dev = resolve_device(device)
    batch = as_frame_batch(trajectory)
    species = np.asarray(batch.species)
    unique, z_to_idx = frame_table.species_table(species)
    n_species = len(unique)
    n_atoms = batch.num_atoms

    rmax = float(np.max(list(nb_set_and_cutoff.values())))
    bins = int(rmax // dr)
    r = np.arange(bins) * dr
    v_shell = shell_volumes(bins, dr)
    n_per_species = np.array([(species == z).sum() for z in unique],
                             dtype=np.float64)
    positions, species_idx = pair_engine.pad_atoms(
        np.asarray(batch.positions, dtype=np.float32),
        z_to_idx[species].astype(np.int32))
    positions = _tensor(positions, dev)
    species_idx = _tensor(species_idx, dev)
    cells32 = _tensor(batch.cell, dev, np.float32)
    inv_cells = pair_engine.inverse_cell(cells32)
    volumes = np.abs(np.linalg.det(np.asarray(batch.cell, np.float64)))

    cols = {"Step": np.asarray(step)}
    cols.update({nn_set: np.empty(batch.num_frames)
                 for nn_set in nb_set_and_cutoff})
    for f in range(batch.num_frames):
        counts = pair_engine.frame_rdf_counts(
            positions[f], cells32[f], species_idx, float(dr), n_species,
            bins, inv_cell=inv_cells[f],
        ).cpu().numpy().astype(np.float64)
        density = n_atoms / volumes[f]
        for nn_set, cutoff in nb_set_and_cutoff.items():
            a, b = (elements.atomic_numbers[s] for s in nn_set.split("-"))
            i, j = int(z_to_idx[a]), int(z_to_idx[b])
            g = counts[i, j] / (n_per_species[i] * n_atoms / volumes[f]
                                * v_shell)
            cols[nn_set][f] = get_coordination_number(r, g, cutoff, density)
    return cols


class CoordinationNumber:
    """Coordination number from per-frame RDF integration.

    Deprecated path kept for API parity (amof/rdf.py:135-214), subject to
    integration error; prefer ``amof_tpu_torch.cn.CoordinationNumber``.
    """

    def __init__(self):
        import pandas as pd

        logger.warning(
            "Compute CoordinationNumber from RDF, best to use "
            "amof_tpu_torch.cn.CoordinationNumber"
        )
        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, delta_Step=1, first_frame=0,
        dr=0.0001, parallel=False, device="cuda",
    ):
        cn_class = cls()
        batch = as_frame_batch(trajectory)
        step = construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        cn_class.compute_cn(batch, nb_set_and_cutoff, step, dr, parallel,
                            device)
        return cn_class

    def compute_cn(self, batch, nb_set_and_cutoff, step, dr, parallel=False,
                   device="cuda"):
        import pandas as pd

        del parallel  # frames run one after another on the device
        self.data = pd.DataFrame(
            rdf_cn_columns(batch, nb_set_and_cutoff, step, dr, device))

    @classmethod
    def from_file(cls, filename):
        cn_class = cls()
        cn_class.read_cn_file(filename)
        return cn_class

    def read_cn_file(self, filename):
        import pandas as pd

        filename = amof_tpu_torch.files.path.append_suffix(filename, "cn")
        self.data = pd.read_feather(filename)

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "cn")
        self.data.to_feather(filename)


def get_coordination_number(r, rdf, cutoff, density):
    """CN = 4 pi rho Int_0^cutoff g(r) r^2 dr (Simpson), with the global
    number density (reference convention, amof/rdf.py:216-227)."""
    r = np.asarray(r, dtype=np.float64)
    rdf = np.asarray(rdf, dtype=np.float64)
    mask = (r > 0) & (r < cutoff)
    r = r[mask]
    rdf = rdf[mask]
    integral = scipy.integrate.simpson(rdf * (r**2), x=r)
    return 4 * np.pi * density * integral


class RdfPlotter:
    """Overlay plotting of multiple stored RDFs
    (parity: amof/rdf.py:230-268)."""

    def __init__(self):
        self.multiple_rdf_data = {}

    def add_rdf(self, path_to_rdf, rdf_name=None):
        if rdf_name is None:
            rdf_name = path_to_rdf
        self.multiple_rdf_data[rdf_name] = Rdf.from_file(path_to_rdf).data

    @classmethod
    def from_multiple_rdf(cls, list_of_path_to_rdf, list_of_rdf_name=None):
        if list_of_rdf_name is None:
            list_of_rdf_name = list_of_path_to_rdf
        plotter = cls()
        for path, name in zip(list_of_path_to_rdf, list_of_rdf_name):
            plotter.add_rdf(path, name)
        return plotter

    def plot(self, nn_set, path_to_plot=None, xlim=None):
        import matplotlib.pyplot as plt

        for rdf_name, rdf_data in self.multiple_rdf_data.items():
            plt.plot(rdf_data["r"], rdf_data[nn_set], label=rdf_name,
                     alpha=0.9, linewidth=1)
        plt.legend()
        plt.xlabel(r"$r$ ($\AA$)")
        plt.ylabel("$g(r)$")
        if xlim is not None:
            plt.xlim(xlim[0], xlim[-1])
        plt.title(nn_set)
        if path_to_plot is not None:
            plt.savefig(str(path_to_plot) + ".png", dpi=300)
        plt.show()
