"""Kernel #1's share of its roofline in the traced units on flexible-cell
pieces, its general-cell branch (``work/rdf_counts_blocked_npt.py``)."""


def read(tr):
    return tr.roofline_pct("rdf_counts_blocked_npt")
