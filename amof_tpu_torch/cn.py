"""
Cutoff coordination numbers on the card.

Counterpart of ``amof_tpu/cn.py`` (API parity with amof/cn.py):
``CoordinationNumber.from_trajectory(traj, nb_set_and_cutoff, delta_Step,
first_frame, parallel, device='cuda')``, per-frame mean CN per pair spec
in a DataFrame indexed by Step, and the '.cn' feather round-trip.

Two passes give the same counts:
  * the full pass (``pair_engine.frame_cn_counts``, O(N^2) per frame);
  * the sorted-window pass (``pair_engine.frame_cn_counts_windowed``,
    kernel #4's table) when the cutoffs are small next to the box; a
    frame whose window missed (or whose table overflowed) is recomputed
    with the full pass, so the choice never changes a result.
The port takes the windowed pass on every device whenever the table rule
of ``ops/frame_table.py`` gives a window (the fused step's and BAD's
rule); ``amof_tpu`` keeps it to its CPU backend, a TPU measurement
(amof_tpu/cn.py:118-122). The frames' miss flags stay on the device
until every frame has run and are read once a call; the flagged frames
then rerun with the full pass. Counters ``cn.frames``,
``cn.frames_windowed`` and ``cn.frames_full`` (``tracing``) say how often
each pass was kept.

The device work lives in ``cn_columns`` (ordered numpy columns, no
pandas); the class wraps them in a DataFrame.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

import amof_tpu_torch.files.path
from amof_tpu_torch import tracing
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.core.step import construct_step
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import frame_table, pair_engine
from amof_tpu_torch.warmup import resolve_device

logger = logging.getLogger(__name__)


def cn_table(counts, species, unique, z_to_idx, nb_set_and_cutoff, step):
    """Ordered CN columns {"Step", one per pair spec} from per-frame
    ordered-pair counts [F, S, S] (amof_tpu/cn.py:158-167)."""
    counts = np.asarray(counts, dtype=np.float64)
    species = np.asarray(species)
    n_per_species = np.array([(species == z).sum() for z in unique],
                             dtype=np.float64)
    cols = {"Step": step}
    for nb_set in nb_set_and_cutoff:
        a, b = (elements.atomic_numbers[s] for s in nb_set.split("-"))
        ia, ib = int(z_to_idx[a]), int(z_to_idx[b])
        with np.errstate(invalid="ignore"):
            cols[nb_set] = counts[:, ia, ib] / n_per_species[ia]
    return cols


def cn_columns(trajectory, nb_set_and_cutoff, step, device="cuda"):
    """Per-frame mean coordination numbers as ordered numpy columns (what
    ``CoordinationNumber.from_trajectory`` puts in ``.data``)."""
    batch = as_frame_batch(trajectory)
    logger.info("Start computing coordination number for %s frames",
                batch.num_frames)
    unique, z_to_idx, plan, a = frame_table.entry_table(
        batch, nb_set_and_cutoff, resolve_device(device), with_bad=False)
    n_species, chunk, window = plan.n_species, plan.chunk, plan.window
    n_frames = batch.num_frames
    counts = torch.empty((n_frames, n_species, n_species),
                         dtype=torch.float32, device=a.positions.device)
    full = range(n_frames)
    if window is not None:
        missed = torch.empty(n_frames, dtype=torch.bool,
                             device=a.positions.device)
        for f in range(n_frames):
            counts[f], missed[f] = pair_engine.frame_cn_counts_windowed(
                a.positions[f], a.cells[f], a.species_idx, a.cutoff_matrix,
                n_species, chunk, window, inv_cell=a.inv_cells[f])
        full = missed.nonzero().flatten().tolist()  # the call's one wait
    for f in full:
        counts[f] = pair_engine.frame_cn_counts(
            a.positions[f], a.cells[f], a.species_idx, a.cutoff_matrix,
            n_species, chunk, inv_cell=a.inv_cells[f])
    tracing.count("cn.frames", n_frames)
    tracing.count("cn.frames_windowed", n_frames - len(full))
    tracing.count("cn.frames_full", len(full))
    return cn_table(counts.cpu().numpy(), batch.species, unique, z_to_idx,
                    nb_set_and_cutoff, step)


class CoordinationNumber:
    """Mean coordination number per frame and pair spec."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"Step": np.empty([0])})

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, delta_Step=1, first_frame=0,
        parallel=False, device="cuda",
    ):
        """Args:
            nb_set_and_cutoff: dict, keys 'A-B' pair strings, values
                cutoffs in Å.
        """
        cn_class = cls()
        batch = as_frame_batch(trajectory)
        step = construct_step(
            delta_Step=delta_Step, first_frame=first_frame,
            number_of_frames=batch.num_frames,
        )
        cn_class.compute_cn(batch, nb_set_and_cutoff, step, parallel, device)
        return cn_class

    def compute_cn(self, batch, nb_set_and_cutoff, step, parallel=False,
                   device="cuda"):
        import pandas as pd

        del parallel  # frames run one after another on the device
        self.data = pd.DataFrame(
            cn_columns(batch, nb_set_and_cutoff, step, device))

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
