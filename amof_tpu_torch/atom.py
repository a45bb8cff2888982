"""
Per-frame atom utilities.

API parity with amof/atom.py: ``get_density`` :11, ``get_number_density``
:18, ``get_total_mass`` :25, ``select_species_positions`` :29,
``get_atomic_numbers_unique`` :44, ``format_cutoff`` :48,
``get_neighborlist`` :72 — the last backed by amof_tpu_torch's own periodic
pair search instead of ASE's.
"""

from __future__ import annotations

import numpy as np

from amof_tpu_torch.data import elements
from amof_tpu_torch.ops.neighbors_host import cutoff_dict_to_matrix, neighbor_pairs

CONVERSION_FACTOR_UMA_A3_TO_KG_L = 1.66053906660


def get_density(frame):
    """Mass density in kg/L (uma/Å^3 x conversion factor)."""
    return CONVERSION_FACTOR_UMA_A3_TO_KG_L * get_total_mass(frame) / frame.get_volume()


def get_number_density(frame):
    """Number density in Å^-3."""
    return len(frame) / frame.get_volume()


def get_total_mass(frame):
    return float(np.sum(frame.get_masses()))


def select_species_positions(frame, atomic_number):
    """Positions of atoms of one species (all atoms if None)."""
    if atomic_number is None:
        return frame.get_positions()
    return frame.get_positions()[frame.get_atomic_numbers() == atomic_number]


def get_atomic_numbers_unique(frame):
    """List of atomic numbers present in the frame."""
    return list(set(frame.get_atomic_numbers().tolist()))


def format_cutoff(nb_set_and_cutoff, format="ase", sort_pair=False):
    """Convert {'Zn-N': 2.5, ...} into {(30, 7): 2.5, ...}.

    Same tuple convention as the reference (amof/atom.py:48-70); with
    ``sort_pair`` the atomic-number tuples are sorted.
    """
    if format == "ase":
        cutoff_dict = {}
        for nn_set, cutoff in nb_set_and_cutoff.items():
            xx = tuple(elements.atomic_numbers[i] for i in nn_set.split("-"))
            if sort_pair:
                xx = tuple(sorted(xx))
            cutoff_dict[xx] = cutoff
        return cutoff_dict
    raise ValueError(f"unsupported format {format!r}")


def get_neighborlist(frame, cutoff_dict):
    """Per-atom adjacency lists under symmetric per-species-pair cutoffs.

    nl[i] lists the indices of all neighbors of atom i (periodic images
    included, an atom may appear several times if it neighbors i through
    several images) — the structure the reference builds from
    ase.neighborlist.neighbor_list('ij', ...) at amof/atom.py:72-87.
    """
    cutoff_matrix = cutoff_dict_to_matrix(cutoff_dict)
    i_idx, j_idx, _, _ = neighbor_pairs(
        frame.get_positions(),
        frame.get_cell(),
        frame.pbc,
        cutoff_matrix,
        species=frame.get_atomic_numbers(),
    )
    nl = [[] for _ in range(frame.get_global_number_of_atoms())]
    for i, j in zip(i_idx, j_idx):
        nl[i].append(int(j))
    return nl
