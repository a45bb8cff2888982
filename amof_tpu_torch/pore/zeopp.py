"""
Zeo++ defaults, unit constants and the connectivity-grid sizing rule used
by the batched pore path (numpy copies of ``amof_tpu/pore/zeopp.py``).

The per-frame ``analyze_frame`` and the rest of that module are not part
of the port yet.
"""

from __future__ import annotations

import numpy as np

DEFAULT_PROBE_RADIUS = 1.2
DEFAULT_CHAN_RADIUS = 1.2
DEFAULT_NUM_SAMPLES = 50000

# unit conversions
A2_PER_A3_TO_M2_PER_CM3 = 1.0e4
AMU_TO_G = 1.66053906660e-24
A2_TO_M2 = 1.0e-20
A3_TO_CM3 = 1.0e-24


def _grid_dims(cell, resolution):
    """Voxel counts per cell axis for a target spacing, rounded up to
    multiples of 4 (at least 8)."""
    lengths = np.linalg.norm(np.asarray(cell, dtype=np.float64), axis=1)
    return tuple(
        int(-(-max(8, int(np.ceil(l / resolution))) // 4) * 4)
        for l in lengths
    )
