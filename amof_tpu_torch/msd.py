"""
Mean-squared displacement on the card.

Counterpart of ``amof_tpu/msd.py`` (API parity with amof/msd.py):
``WindowMsd.from_trajectory(traj, delta_time=100, max_time='half',
timestep=1, parallel, unwrap, origin_policy, device='cuda')`` with the
reference's window construction, per-species columns and the
formula-weighted total column "X", the unwrap / COM-drift pipeline, and
the '.msd' feather round-trip; ``DirectMsd`` (deprecated, orthogonal
cells: MSD against frame 0 after the reference's per-axis modulo unwrap).

The per-window rolling-sum loop is replaced by FFT autocorrelation on
the device (``ops/msd_kernel.py``); ``origin_policy='amof'`` reproduces
the reference's estimator, which skips the k=0 origin.

The device work lives in pandas-free functions (``msd_columns``,
``direct_msd_columns``); the classes wrap them in a DataFrame (pandas is
imported inside the classes).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

import amof_tpu_torch.files.path
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.core.step import construct_step
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import msd_kernel
from amof_tpu_torch.ops.pair_engine import inverse_cell
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)


def msd_windows(n_frames: int, delta_time=100, max_time="half", timestep=1,
                clamp: bool = False):
    """(window m values, times in fs) of the reference
    (amof/msd.py:174-182); raises when delta_time < timestep (the
    reference only logs there and then fails on a zero-step arange),
    unless ``clamp``, which steps by one frame there (the fused
    ``pipelines.analyze`` rule)."""
    half_time = (n_frames // 2) * timestep
    if max_time == "half" or max_time > half_time:
        max_time = half_time
    if delta_time < timestep and not clamp:
        raise ValueError("delta_time should be larger than timestep")
    window = np.arange(0, max_time // timestep,
                       max(1, delta_time // timestep))
    return window, timestep * window


def msd_table(msd_all, msd_species, unique, window, time):
    """WindowMsd's ordered columns ("Time", one per species, "X") from
    per-frame MSDs: ``msd_species`` [F, S] over the sorted atomic numbers
    ``unique``, ``msd_all`` [F] the total."""
    cols = {"Time": time}
    for i, z in enumerate(unique):
        cols[elements.symbol_of(z)] = msd_species[window, i]
    cols["X"] = msd_all[window]
    return cols


def msd_columns(trajectory, window, time, unwrap=False, origin_policy="amof",
                device="cuda"):
    """Windowed MSD as ordered numpy columns ("Time", one per species,
    "X"): what ``WindowMsd.from_trajectory`` puts in ``.data``."""
    dev = resolve_device(device)
    batch = as_frame_batch(trajectory)
    species = np.asarray(batch.species)
    unique = sorted(set(species.tolist()))
    positions = torch.from_numpy(
        np.ascontiguousarray(batch.positions, dtype=np.float32)).to(dev)
    cells = torch.from_numpy(
        np.ascontiguousarray(batch.cell, dtype=np.float32)).to(dev)
    inv = inverse_cell(cells)
    masses = torch.from_numpy(
        elements.mass_of(species).astype(np.float32)).to(dev)

    logger.info("Start computing msd at %s times on a trajectory of %s "
                "frames", len(window), batch.num_frames)
    if unwrap:
        logger.info("Unwrap trajectory before computing msd")
        positions = msd_kernel.unwrap_positions(positions, cells, inv)
    positions = msd_kernel.remove_com_drift(positions, masses)

    per_species, counts = [], []
    for z in unique:
        sel = torch.from_numpy(np.nonzero(species == z)[0]).to(dev)
        counts.append(len(sel))
        xs = msd_kernel.unwrap_positions(positions[:, sel], cells, inv)
        per_species.append(
            msd_kernel.windowed_msd_all_m(xs, origin_policy).cpu().numpy())
    # formula-weighted total (amof/msd.py:263-268)
    total = sum(m * cnt for m, cnt in zip(per_species, counts)) / sum(counts)
    return msd_table(total, np.stack(per_species, axis=1), unique,
                     np.asarray(window), time)


def _species_msd(positions, cells):
    """Reference per-axis modulo unwrap + MSD vs frame 0 (amof/msd.py:
    84-107 semantics), float64 on the tensors' device."""
    n_frames, n_atoms, _ = positions.shape
    msd = torch.zeros(n_frames, dtype=torch.float64, device=positions.device)
    r_0 = positions[0].double()
    r_t = r_0.clone()
    for t in range(1, n_frames):
        a = torch.diagonal(cells[t].double())
        dr = positions[t].double() - torch.remainder(r_t, a)
        dr -= a * (dr > a / 2)
        dr += a * (dr < -a / 2)
        r_t = r_t + dr
        msd[t] = torch.sum((r_t - r_0) ** 2) / n_atoms
    return msd


def direct_msd_columns(trajectory, step, device="cuda"):
    """DirectMsd's ordered numpy columns ("Step", "X", one per species)."""
    dev = resolve_device(device)
    batch = as_frame_batch(trajectory)
    species = np.asarray(batch.species)
    positions = torch.from_numpy(np.asarray(batch.positions)).to(dev)
    cells = torch.from_numpy(np.asarray(batch.cell)).to(dev)
    cols = {"Step": step, "X": _species_msd(positions, cells).cpu().numpy()}
    for z in sorted(set(species.tolist())):
        sel = torch.from_numpy(np.nonzero(species == z)[0]).to(dev)
        cols[elements.symbol_of(z)] = _species_msd(
            positions[:, sel], cells).cpu().numpy()
    return cols


class Msd:
    """Base class: '.msd' feather persistence (amof/msd.py:25-51)."""

    def write_to_file(self, path_to_output):
        path_to_output = amof_tpu_torch.files.path.append_suffix(
            path_to_output, "msd")
        self.data.to_feather(path_to_output)

    @classmethod
    def from_msd(cls, *args):
        logger.exception("from_msd is deprecated, use from_file instead")

    @classmethod
    def from_file(cls, path_to_msd):
        msd_class = cls()
        msd_class.read_msd_file(path_to_msd)
        return msd_class

    def read_msd_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "msd")
        self.data = pd.read_feather(path_to_data)


class WindowMsd(Msd):
    """Windowed MSD:
    MSD(m) = <|r_i(k+m) - r_i(k)|^2>_{i,k}, x-axis 'Time' in fs."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Time": np.empty([0])})

    @classmethod
    def from_trajectory(
        cls, trajectory, delta_time=100, max_time="half", timestep=1,
        parallel=False, unwrap=False, origin_policy="amof", device="cuda",
    ):
        """Args:
            delta_time: time between two computed MSD values (fs).
            max_time: int (fs) or 'half' (= half the simulation length;
                larger values are clamped to it).
            timestep: time between two frames (fs).
            unwrap: unwrap the trajectory first (use when the MD code
                wrapped positions without keeping the COM constant).
            origin_policy: 'amof' replicates the reference estimator
                (skips the k=0 origin); 'standard' keeps all origins.
        """
        msd_class = cls()
        batch = as_frame_batch(trajectory)
        window, time = msd_windows(batch.num_frames, delta_time, max_time,
                                   timestep)
        msd_class.compute_msd(batch, window, time, parallel, unwrap,
                              origin_policy, device)
        return msd_class

    @staticmethod
    def compute_msd_of_m(delta_pos, m):
        """Windowed MSD(m) by the reference's rolling-sum recurrence
        (amof/msd.py:186-205), including its skipped first origin
        (origin_policy='amof'). A host numpy oracle for the FFT path."""
        delta_pos = np.asarray(delta_pos, dtype=np.float64)
        n = len(delta_pos)
        partial = np.zeros(n - m)
        r_lag = delta_pos[0].copy()
        r_k = delta_pos[: m + 1].sum(axis=0)
        for k in range(m + 1, n):
            r_k = r_k + delta_pos[k]
            r_lag = r_lag + delta_pos[k - m]
            partial[k - m] = (
                np.linalg.norm(r_k - r_lag) ** 2 / len(r_lag)
            )
        return float(np.mean(partial))

    def compute_msd(self, batch, window, time, parallel=False, unwrap=False,
                    origin_policy="amof", device="cuda"):
        import pandas as pd

        del parallel  # species run one after another on the device
        self.data = pd.DataFrame(msd_columns(batch, window, time, unwrap,
                                             origin_policy, device))


class DirectMsd(Msd):
    """Direct MSD vs frame 0 (deprecated; orthogonal cells only;
    parity: amof/msd.py:54-137)."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Step": np.empty([0])})
        logger.warning(
            "DirectMsd is deprecated and not suitable for non-orthogonal "
            "cells, use WindowMsd instead"
        )

    @classmethod
    def from_trajectory(cls, trajectory, delta_Step=1, first_frame=0,
                        parallel=False, device="cuda"):
        msd_class = cls()
        batch = as_frame_batch(trajectory)
        step = construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        msd_class.compute_msd(batch, step, parallel, device)
        return msd_class

    def compute_species_msd(self, trajectory, atomic_number=None,
                            device="cuda"):
        """Direct MSD of one species (or of all atoms) vs frame 0 (parity:
        amof/msd.py:84-108; orthogonal cells only): float64 numpy [F]."""
        dev = resolve_device(device)
        batch = as_frame_batch(trajectory)
        positions = np.asarray(batch.positions)
        if atomic_number is not None:
            positions = positions[:, np.asarray(batch.species) == atomic_number]
        return _species_msd(
            torch.from_numpy(np.ascontiguousarray(positions)).to(dev),
            torch.from_numpy(np.asarray(batch.cell)).to(dev)).cpu().numpy()

    def compute_msd(self, batch, step, parallel=False, device="cuda"):
        import pandas as pd

        del parallel
        self.data = pd.DataFrame(direct_msd_columns(batch, step, device))
