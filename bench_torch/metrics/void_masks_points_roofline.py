"""Kernel #5's share of its roofline in the traced units
(``work/void_masks_points.py``)."""


def read(tr):
    return tr.roofline_pct("void_masks_points")
