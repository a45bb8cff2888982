"""
Dummy-symbol registry for coarse-grained species.

Maps fragment names (Im, mIm, ImCycle, ...) to unused 7th-period element
symbols so reduced frames remain valid xyz. Behavior parity:
amof/symbols.py:20-90 (including the JSON round-trip format).
"""

from __future__ import annotations

import json

from amof_tpu_torch.data.elements import chemical_symbols
import amof_tpu_torch.files.path

# Seventh period of the periodic table — elements unlikely to appear in
# MOF simulations, used as placeholders for fragment names.
chemical_symbols_seventh_period = [
    "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm", "Md", "No", "Lr",
    "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds", "Rg", "Cn", "Nh", "Fl", "Mc",
    "Lv", "Ts", "Og",
]


class DummySymbols:
    """Bidirectional mapping between fragment names and stand-in symbols."""

    def __init__(self, names=None):
        self.from_name_to_symbol = {}
        self.from_symbol_to_name = {}
        self.names = []
        self.nb_changed_names = 0
        self.available_chemical_symbols = list(chemical_symbols_seventh_period)
        if names is not None:
            self.add_names(names)

    def add_names(self, names):
        """Register names not already present; names that are real chemical
        symbols keep themselves, others get the next free 7th-period
        symbol."""
        new_names = [n for n in names if n not in self.names]
        for name in new_names:
            if name in chemical_symbols:
                pt_symbol = name
                if name in self.available_chemical_symbols:
                    self.available_chemical_symbols.remove(name)
            else:
                pt_symbol = self.available_chemical_symbols[self.nb_changed_names]
                self.nb_changed_names += 1
            self.from_name_to_symbol[name] = pt_symbol
            self.from_symbol_to_name[pt_symbol] = name
            self.names.append(name)

    def get_symbol(self, name):
        return self.from_name_to_symbol[name]

    def get_name(self, symbol):
        return self.from_symbol_to_name[symbol]

    @classmethod
    def from_file(cls, filename):
        new = cls()
        new.read_file(filename)
        return new

    def read_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "symbols")
        with open(filename) as f:
            self.from_name_to_symbol = json.load(f)
        self.from_symbol_to_name = {v: k for k, v in self.from_name_to_symbol.items()}
        self.names = list(self.from_name_to_symbol.keys())
        self.nb_changed_names = sum(
            v == k for k, v in self.from_name_to_symbol.items()
        )
        self.available_chemical_symbols = [
            s for s in self.available_chemical_symbols if s not in self.names
        ]

    def write_to_file(self, filename):
        filename = amof_tpu_torch.files.path.append_suffix(filename, "symbols")
        with open(filename, "w") as fp:
            json.dump(self.from_name_to_symbol, fp)

    def __str__(self):
        return ", ".join(
            ":".join([k, v]) for k, v in self.from_name_to_symbol.items()
        )
