from amof_tpu_torch.data.elements import (
    atomic_numbers,
    atomic_masses,
    chemical_symbols,
    covalent_radii,
    vdw_radii,
    mass_of,
    symbol_of,
    number_of,
)

__all__ = [
    "atomic_numbers",
    "atomic_masses",
    "chemical_symbols",
    "covalent_radii",
    "vdw_radii",
    "mass_of",
    "symbol_of",
    "number_of",
]
