"""Kernel #6's share of its roofline in the traced units
(``work/surface_valid_columns.py``)."""


def read(tr):
    return tr.roofline_pct("surface_valid_columns")
