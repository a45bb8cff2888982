"""Kernel #7's share of its roofline in the traced units
(``work/propagate_fixpoint.py``)."""


def read(tr):
    return tr.roofline_pct("propagate_fixpoint")
