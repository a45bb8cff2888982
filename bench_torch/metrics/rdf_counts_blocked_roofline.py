"""Kernel #1's share of its roofline in the traced units
(``work/rdf_counts_blocked.py``)."""


def read(tr):
    return tr.roofline_pct("rdf_counts_blocked")
