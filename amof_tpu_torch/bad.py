"""
Bond-angle distributions on the card.

Counterpart of ``amof_tpu/bad.py`` (API parity with amof/bad.py):
``Bad.from_trajectory(traj, nb_set_and_cutoff, dtheta=0.05,
normalization='total', parallel, device='cuda')`` with ``.data``
(density-normalized B-A-B columns over ``theta``), the wildcard "X"
enumeration (amof/bad.py:122-133), ``bins = int(180 // dtheta)``,
``theta = arange(bins+1)*dtheta + dtheta/2`` and the '.bad' feather
round-trip; ``BadByCn`` resolves the BAD per coordination number into a
labeled (atom_triple x cn x theta) array with 'total'/'partial'
normalization, serialized as netCDF (``labeled.py``); ``CoreBad.bad_BAB``
is the host-side per-frame helper.

``_compute_counts`` runs the retry ladder of ``amof_tpu`` over the whole
trajectory: the 2-level slab table (kernel #3, on the card only), then
the 1-level sorted window (kernel #4), then the full table, then K
doubling from 16 up to 512, after which it raises. Neighbour capacity
overflow or a window miss therefore never drops an angle silently.

The device work lives in pandas-free functions (``bad_columns``,
``bad_by_cn_dataset``); ``Bad`` wraps its columns in a DataFrame (pandas
is imported inside the class).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

import amof_tpu_torch.files.path
from amof_tpu_torch import labeled
from amof_tpu_torch.cn import _cutoff_matrix_for_species, sorted_window
from amof_tpu_torch.core.frames import as_frame_batch
from amof_tpu_torch.data import elements
from amof_tpu_torch.ops import bad_kernel, pair_engine, slab_table
from amof_tpu_torch.rdf import _species_table

logger = logging.getLogger(__name__)

_FIRST_CAPACITY = 16
_MAX_NEIGHBOR_CAPACITY = 512


def _enumerate_specs(nb_set_and_cutoff, unique):
    """Wildcard-aware (center, outer) pair enumeration + column names.

    Mirrors amof/bad.py:122-133: "X" is appended iff the cutoff spec
    covers every species present; pairs with identical center and outer
    species are excluded except ("X", "X").
    """
    present = sorted(
        {
            elements.atomic_numbers[s]
            for nb_set in nb_set_and_cutoff
            for s in nb_set.split("-")
        }
    )
    epu: list = list(present)
    if len(epu) == len(unique):
        epu.append("X")
    pairs = [
        (a, b)
        for b in epu
        for a in epu
        if (a not in [b, "X"] or ((a, b) == ("X", "X")))
    ]
    names = []
    for a, b in pairs:
        sym = lambda x: "X" if x == "X" else elements.symbol_of(x)
        names.append("-".join([sym(b), sym(a), sym(b)]))
    return pairs, names


def _slab_rung(dev: torch.device) -> bool:
    """The 2-level slab rung runs on the card only (``amof_tpu`` takes it
    on accelerators only, amof_tpu/bad.py:120)."""
    return dev.type == "cuda"


def bad_table(counts, names, theta, dtheta):
    """Ordered BAD columns {"theta", one per spec with angles} from the
    spec counts [spec, cn, bins] (amof_tpu/bad.py:234-239)."""
    cols = {"theta": theta}
    angle_counts = np.asarray(counts, np.float64).sum(axis=1)  # over cn
    for s, name in enumerate(names):
        total = angle_counts[s].sum()
        if total > 0:
            cols[name] = angle_counts[s] / (total * dtheta)
    return cols


def _compute_counts(batch, nb_set_and_cutoff, dtheta, by_cn=False,
                    device="cuda"):
    """Accumulated angle counts [n_specs, cn_slots, bins+1] over all
    frames, the spec names and theta. cn_slots == 1 unless by_cn (the
    BadByCn axis, K + 1 at the capacity the ladder ended on)."""
    from amof_tpu_torch.parallel.pipeline import resolve_device

    dev = resolve_device(device)
    species = np.asarray(batch.species)
    unique, z_to_idx = _species_table(species)
    cutoff_matrix = _cutoff_matrix_for_species(nb_set_and_cutoff, unique,
                                               z_to_idx)
    pairs, names = _enumerate_specs(nb_set_and_cutoff, unique)
    specs = tuple(
        (
            -1 if a == "X" else int(z_to_idx[a]),
            -1 if b == "X" else int(z_to_idx[b]),
        )
        for a, b in pairs
    )
    bins_ref = int(180 // dtheta)
    n_hist_bins = bins_ref + 1
    theta = np.arange(bins_ref + 1) * dtheta + dtheta / 2

    positions, species_idx = pair_engine.pad_atoms(
        np.asarray(batch.positions, dtype=np.float32),
        z_to_idx[species].astype(np.int32))
    n_pad = positions.shape[1]
    chunk = pair_engine._pick_chunk(n_pad)
    cells = np.asarray(batch.cell, dtype=np.float32)
    n_species = len(unique)

    # sorted-window table when the cutoffs are small next to the box; a
    # miss raises the overflow flag and the ladder below drops to the
    # full table. The 2-level slab upgrade runs on the card.
    rc = float(cutoff_matrix.max())
    window = None
    if n_pad >= 2048 and rc > 0:
        window = sorted_window(cells, rc, n_pad, chunk)
    slab = None
    if window is not None and _slab_rung(dev):
        slab = slab_table.slab_plan(cells, rc, n_pad, positions=positions,
                                    species_idx=species_idx)

    pos = torch.from_numpy(positions).to(dev)
    cells_t = torch.from_numpy(np.ascontiguousarray(cells)).to(dev)
    inv = pair_engine.inverse_cell(cells_t)
    sp = torch.from_numpy(species_idx).to(dev)
    cut = torch.from_numpy(cutoff_matrix).to(dev)
    max_neighbors = _FIRST_CAPACITY
    while True:
        conc, center_any, overflow = bad_kernel.trajectory_bad_counts(
            pos, cells_t, sp, cut, n_species, float(dtheta), n_hist_bins,
            max_neighbors, chunk, by_cn=by_cn, window=window, slab=slab,
            inv_cells=inv,
        )
        if not bool(overflow):
            break
        if slab is not None:
            # could be a slab capacity/coverage miss: retry 1-level
            slab = None
            continue
        if window is not None:
            # could be a window miss rather than capacity: drop the
            # window first, then grow capacity
            window = None
            continue
        max_neighbors *= 2
        if max_neighbors > _MAX_NEIGHBOR_CAPACITY:
            raise RuntimeError(
                "neighbor capacity exceeded; cutoffs likely unphysical"
            )
        logger.info(
            "neighbor capacity overflow; retrying with max_neighbors=%s",
            max_neighbors,
        )
    conc = conc.cpu().numpy()
    center_any = center_any.cpu().numpy()
    counts = np.stack(
        [bad_kernel.select_spec_counts(conc, center_any, s) for s in specs]
    )
    return counts, names, theta


def bad_columns(trajectory, nb_set_and_cutoff, dtheta=0.05, device="cuda"):
    """The BAD of a trajectory as ordered numpy columns (what
    ``Bad.from_trajectory`` puts in ``.data``)."""
    batch = as_frame_batch(trajectory)
    logger.info("Start computing bad for %s frames with dtheta = %s",
                batch.num_frames, dtheta)
    counts, names, theta = _compute_counts(batch, nb_set_and_cutoff, dtheta,
                                           device=device)
    return bad_table(counts, names, theta, dtheta)


def bad_by_cn_dataset(trajectory, nb_set_and_cutoff, dtheta=0.05,
                      normalization="total", device="cuda"):
    """BadByCn's ``labeled.Dataset``: variable "bad" over (atom_triple,
    cn, theta), one row per coordination number a spec has angles at;
    'partial' weighs each row by its share of the spec's angles
    (amof_tpu/bad.py:265-299)."""
    batch = as_frame_batch(trajectory)
    logger.info("Start computing bad by cn for %s frames with dtheta = %s",
                batch.num_frames, dtheta)
    counts, names, theta = _compute_counts(batch, nb_set_and_cutoff, dtheta,
                                           by_cn=True, device=device)
    # counts: [spec, cn(K+1), bins]
    per_spec = []
    kept_names = []
    for s, name in enumerate(names):
        cn_totals = counts[s].sum(axis=1)  # [K+1]
        cn_values = np.nonzero(cn_totals > 0)[0]
        if len(cn_values) == 0:
            continue
        num_angles_all = cn_totals.sum()
        rows = []
        for cn in cn_values:
            ratio = (cn_totals[cn] / num_angles_all
                     if normalization == "partial" else 1.0)
            rows.append(ratio * counts[s, cn] / (cn_totals[cn] * dtheta))
        per_spec.append(
            labeled.DataArray(
                np.array(rows),
                coords={"cn": cn_values.astype(np.int64), "theta": theta},
                dims=("cn", "theta"),
            )
        )
        kept_names.append(name)
    if not per_spec:
        return labeled.Dataset()
    arr = labeled.concat(per_spec, "atom_triple", labels=np.array(kept_names),
                         fill=np.nan)
    return labeled.Dataset({"bad": arr.rename("bad")})


class CoreBad:
    """Shared constructors (parity: amof/bad.py:33-59)."""

    @classmethod
    def from_trajectory(
        cls, trajectory, nb_set_and_cutoff, dtheta=0.05,
        normalization="total", parallel=False, device="cuda",
    ):
        """Args:
            nb_set_and_cutoff: dict, 'A-B' pair strings -> cutoff in Å.
            dtheta: bin width in degrees (0.05 default, as RINGS).
            normalization: 'total' or 'partial' (BadByCn only).
        """
        bad_class = cls()
        bad_class.compute_bad(
            trajectory, nb_set_and_cutoff, dtheta, normalization, parallel,
            device,
        )
        return bad_class

    @classmethod
    def from_file(cls, filename):
        bad_class = cls()
        bad_class.read_bad_file(filename)
        return bad_class

    @staticmethod
    def bad_BAB(atom, A, B, nl):
        """B-A-B angles of one frame from a per-atom neighbor-list dict
        (parity: amof/bad.py:71-101). Host-side compatibility helper: the
        analysis path runs the device tables instead.

        Args:
            atom: a Frame (or ASE-compatible) object.
            A, B: atomic numbers, or "X" wildcards.
            nl: {atom index: [neighbor indices]}.
        """
        import itertools

        numbers = atom.get_atomic_numbers()
        angles = []
        for a in range(len(numbers)):
            if A == "X" or numbers[a] == A:
                b_nb = [
                    i for i in nl[a] if B == "X" or numbers[i] == B
                ]
                angle_idx = [
                    [i, a, j] for i, j in itertools.combinations(b_nb, 2)
                ]
                if angle_idx:
                    angles += list(atom.get_angles(angle_idx, mic=True))
        return angles


class Bad(CoreBad):
    """Bond-angle distribution, density-normalized over all frames."""

    def __init__(self):
        import pandas as pd

        self.data = pd.DataFrame({"theta": np.empty([0])})

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False, device="cuda"):
        import pandas as pd

        del normalization, parallel  # parity args; 'total' is the only mode
        self.data = pd.DataFrame(
            bad_columns(trajectory, nb_set_and_cutoff, dtheta, device))

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data.to_feather(filename)

    def read_bad_file(self, path_to_data):
        import pandas as pd

        path_to_data = amof_tpu_torch.files.path.append_suffix(
            path_to_data, "bad")
        self.data = pd.read_feather(path_to_data)


class BadByCn(CoreBad):
    """BAD resolved by coordination number (labeled atom_triple x cn x
    theta array; parity: amof/bad.py:172-309). Needs no pandas."""

    def __init__(self):
        self.data = labeled.Dataset()

    def compute_bad(self, trajectory, nb_set_and_cutoff, dtheta=0.05,
                    normalization="total", parallel=False, device="cuda"):
        del parallel
        self.data = bad_by_cn_dataset(trajectory, nb_set_and_cutoff, dtheta,
                                      normalization, device)

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data.to_netcdf(filename)

    def read_bad_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "bad")
        self.data = labeled.open_dataset(filename)
