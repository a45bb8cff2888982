"""Kernel #2's share of its roofline in the traced units
(``work/rdf_counts.py``)."""


def read(tr):
    return tr.roofline_pct("rdf_counts")
