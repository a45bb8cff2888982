"""
Periodic-table data used throughout amof_tpu_torch.

The reference delegates to ``ase.data`` (chemical_symbols, atomic_numbers,
atomic_masses — e.g. amof/rdf.py:108, amof/atom.py:65) and to pymatgen's
``CovalentRadius`` table (amof/coordination/core.py:240-244). Neither ASE
nor pymatgen is a dependency of this rebuild, so the standard public data
is embedded here directly.

Sources (public scientific constants):
  - chemical symbols / numbers: IUPAC periodic table, index == Z, 'X' at 0
    (same layout as ase.data so downstream indexing is interchangeable).
  - atomic masses: IUPAC 2021 standard atomic weights (conventional values
    for intervals; most-stable-isotope mass for elements with no stable
    isotope).
  - covalent radii: B. Cordero et al., Dalton Trans. 2008,
    DOI 10.1039/b801115j — the same table pymatgen's CovalentRadius wraps.
    For carbon the sp2 value 0.73 is used, matching pymatgen and the
    worked-out cutoffs in the reference docstrings
    (amof/coordination/zif.py:26-30: C-C 2*0.73*1.2 = 1.752,
    C-N (0.73+0.71)*1.2 = 1.728, Zn-N (1.22+0.71)*1.5 = 2.895).
    For Mn/Fe/Co the high-spin values are used.
  - van der Waals radii: CSD-derived table as shipped by Zeo++
    (networkinfo.cc defaults), used by the pore module
    (parity target: amof/pore/pysimmzeopp.py). Unknown elements fall back
    to 2.0 Å, BUT the lookup helpers let callers override per element.
"""

from __future__ import annotations

import numpy as np

# Index == atomic number Z; position 0 is the placeholder 'X'.
chemical_symbols = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]

atomic_numbers = {sym: z for z, sym in enumerate(chemical_symbols)}

# Standard atomic weights, indexed by Z ('X' slot holds nan).
atomic_masses = np.array([
    np.nan,       # X
    1.008,        # H
    4.002602,     # He
    6.94,         # Li
    9.0121831,    # Be
    10.81,        # B
    12.011,       # C
    14.007,       # N
    15.999,       # O
    18.998403163, # F
    20.1797,      # Ne
    22.98976928,  # Na
    24.305,       # Mg
    26.9815385,   # Al
    28.085,       # Si
    30.973761998, # P
    32.06,        # S
    35.45,        # Cl
    39.948,       # Ar
    39.0983,      # K
    40.078,       # Ca
    44.955908,    # Sc
    47.867,       # Ti
    50.9415,      # V
    51.9961,      # Cr
    54.938044,    # Mn
    55.845,       # Fe
    58.933194,    # Co
    58.6934,      # Ni
    63.546,       # Cu
    65.38,        # Zn
    69.723,       # Ga
    72.630,       # Ge
    74.921595,    # As
    78.971,       # Se
    79.904,       # Br
    83.798,       # Kr
    85.4678,      # Rb
    87.62,        # Sr
    88.90584,     # Y
    91.224,       # Zr
    92.90637,     # Nb
    95.95,        # Mo
    97.90721,     # Tc
    101.07,       # Ru
    102.90550,    # Rh
    106.42,       # Pd
    107.8682,     # Ag
    112.414,      # Cd
    114.818,      # In
    118.710,      # Sn
    121.760,      # Sb
    127.60,       # Te
    126.90447,    # I
    131.293,      # Xe
    132.90545196, # Cs
    137.327,      # Ba
    138.90547,    # La
    140.116,      # Ce
    140.90766,    # Pr
    144.242,      # Nd
    144.91276,    # Pm
    150.36,       # Sm
    151.964,      # Eu
    157.25,       # Gd
    158.92535,    # Tb
    162.500,      # Dy
    164.93033,    # Ho
    167.259,      # Er
    168.93422,    # Tm
    173.045,      # Yb
    174.9668,     # Lu
    178.49,       # Hf
    180.94788,    # Ta
    183.84,       # W
    186.207,      # Re
    190.23,       # Os
    192.217,      # Ir
    195.084,      # Pt
    196.966569,   # Au
    200.592,      # Hg
    204.38,       # Tl
    207.2,        # Pb
    208.98040,    # Bi
    208.98243,    # Po
    209.98715,    # At
    222.01758,    # Rn
    223.01974,    # Fr
    226.02541,    # Ra
    227.02775,    # Ac
    232.0377,     # Th
    231.03588,    # Pa
    238.02891,    # U
    237.04817,    # Np
    244.06421,    # Pu
    243.06138,    # Am
    247.07035,    # Cm
    247.07031,    # Bk
    251.07959,    # Cf
    252.08298,    # Es
    257.09511,    # Fm
    258.09843,    # Md
    259.10100,    # No
    262.110,      # Lr
    267.122,      # Rf
    268.126,      # Db
    271.134,      # Sg
    270.133,      # Bh
    269.1338,     # Hs
    278.156,      # Mt
    281.165,      # Ds
    281.166,      # Rg
    285.177,      # Cn
    286.182,      # Nh
    289.190,      # Fl
    289.194,      # Mc
    293.204,      # Lv
    293.208,      # Ts
    294.214,      # Og
], dtype=np.float64)

# Cordero 2008 covalent radii in Å, keyed by symbol (pymatgen-compatible
# choices: C sp2 = 0.73; Mn/Fe/Co high-spin).
covalent_radii = {
    "H": 0.31, "He": 0.28,
    "Li": 1.28, "Be": 0.96, "B": 0.84, "C": 0.73, "N": 0.71, "O": 0.66,
    "F": 0.57, "Ne": 0.58,
    "Na": 1.66, "Mg": 1.41, "Al": 1.21, "Si": 1.11, "P": 1.07, "S": 1.05,
    "Cl": 1.02, "Ar": 1.06,
    "K": 2.03, "Ca": 1.76, "Sc": 1.70, "Ti": 1.60, "V": 1.53, "Cr": 1.39,
    "Mn": 1.61, "Fe": 1.52, "Co": 1.50, "Ni": 1.24, "Cu": 1.32, "Zn": 1.22,
    "Ga": 1.22, "Ge": 1.20, "As": 1.19, "Se": 1.20, "Br": 1.20, "Kr": 1.16,
    "Rb": 2.20, "Sr": 1.95, "Y": 1.90, "Zr": 1.75, "Nb": 1.64, "Mo": 1.54,
    "Tc": 1.47, "Ru": 1.46, "Rh": 1.42, "Pd": 1.39, "Ag": 1.45, "Cd": 1.44,
    "In": 1.42, "Sn": 1.39, "Sb": 1.39, "Te": 1.38, "I": 1.39, "Xe": 1.40,
    "Cs": 2.44, "Ba": 2.15, "La": 2.07, "Ce": 2.04, "Pr": 2.03, "Nd": 2.01,
    "Pm": 1.99, "Sm": 1.98, "Eu": 1.98, "Gd": 1.96, "Tb": 1.94, "Dy": 1.92,
    "Ho": 1.92, "Er": 1.89, "Tm": 1.90, "Yb": 1.87, "Lu": 1.87, "Hf": 1.75,
    "Ta": 1.70, "W": 1.62, "Re": 1.51, "Os": 1.44, "Ir": 1.41, "Pt": 1.36,
    "Au": 1.36, "Hg": 1.32, "Tl": 1.45, "Pb": 1.46, "Bi": 1.48, "Po": 1.40,
    "At": 1.50, "Rn": 1.50, "Fr": 2.60, "Ra": 2.21, "Ac": 2.15, "Th": 2.06,
    "Pa": 2.00, "U": 1.96, "Np": 1.90, "Pu": 1.87, "Am": 1.80, "Cm": 1.69,
}

# CSD-derived van der Waals radii in Å (Zeo++ default radius table),
# used by the pore module. Elements absent here fall back to _VDW_DEFAULT.
vdw_radii = {
    "H": 1.09, "He": 1.40, "Li": 1.82, "Be": 2.00, "B": 2.00, "C": 1.70,
    "N": 1.55, "O": 1.52, "F": 1.47, "Ne": 1.54, "Na": 2.27, "Mg": 1.73,
    "Al": 2.00, "Si": 2.10, "P": 1.80, "S": 1.80, "Cl": 1.75, "Ar": 1.88,
    "K": 2.75, "Ca": 2.00, "Sc": 2.00, "Ti": 2.00, "V": 2.00, "Cr": 2.00,
    "Mn": 2.00, "Fe": 2.00, "Co": 2.00, "Ni": 1.63, "Cu": 1.40, "Zn": 1.39,
    "Ga": 1.87, "Ge": 2.00, "As": 1.85, "Se": 1.90, "Br": 1.85, "Kr": 2.02,
    "Rb": 2.00, "Sr": 2.00, "Y": 2.00, "Zr": 2.00, "Nb": 2.00, "Mo": 2.00,
    "Tc": 2.00, "Ru": 2.00, "Rh": 2.00, "Pd": 1.63, "Ag": 1.72, "Cd": 1.58,
    "In": 1.93, "Sn": 2.17, "Sb": 2.00, "Te": 2.06, "I": 1.98, "Xe": 2.16,
    "Cs": 2.00, "Ba": 2.00, "La": 2.00, "Pt": 1.75, "Au": 1.66, "Hg": 1.55,
    "Tl": 1.96, "Pb": 2.02, "Bi": 2.00, "U": 1.86,
}
_VDW_DEFAULT = 2.00


def number_of(symbol: str) -> int:
    """Atomic number of a chemical symbol (case-sensitive, e.g. 'Zn')."""
    return atomic_numbers[symbol]


def symbol_of(z: int) -> str:
    """Chemical symbol of atomic number ``z``."""
    return chemical_symbols[int(z)]


def mass_of(z) -> np.ndarray:
    """Standard atomic weight(s) for atomic number(s) ``z``."""
    return atomic_masses[np.asarray(z, dtype=np.int64)]


def covalent_radius_of(symbol_or_z) -> float:
    """Cordero covalent radius in Å."""
    if isinstance(symbol_or_z, str):
        return covalent_radii[symbol_or_z]
    return covalent_radii[symbol_of(symbol_or_z)]


def vdw_radius_of(symbol_or_z, overrides=None) -> float:
    """van der Waals radius in Å with Zeo++-compatible defaults.

    Args:
        symbol_or_z: chemical symbol or atomic number.
        overrides: optional dict {symbol: radius} taking precedence
            (equivalent of Zeo++'s ``-r`` radii-file option,
            amof/pore/pysimmzeopp.py:114-115).
    """
    sym = symbol_or_z if isinstance(symbol_or_z, str) else symbol_of(symbol_or_z)
    if overrides and sym in overrides:
        return overrides[sym]
    return vdw_radii.get(sym, _VDW_DEFAULT)


def covalent_radius_array(max_z: int = 119) -> np.ndarray:
    """Dense float array of covalent radii indexed by Z (nan if unknown)."""
    out = np.full(max_z, np.nan)
    for sym, r in covalent_radii.items():
        out[atomic_numbers[sym]] = r
    return out


def vdw_radius_array(max_z: int = 119, overrides=None) -> np.ndarray:
    """Dense float array of vdW radii indexed by Z (default 2.0 Å)."""
    out = np.full(max_z, _VDW_DEFAULT)
    for sym, r in vdw_radii.items():
        out[atomic_numbers[sym]] = r
    if overrides:
        for sym, r in overrides.items():
            out[atomic_numbers[sym]] = r
    return out
