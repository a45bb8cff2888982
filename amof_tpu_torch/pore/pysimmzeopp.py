"""Compatibility alias for the reference's module path
(amof/pore/pysimmzeopp.py): the in-process Zeo++-equivalent engine
lives in amof_tpu_torch.pore.zeopp; ``network`` keeps the pysimm-style
signature."""

from amof_tpu_torch.pore.zeopp import (  # noqa: F401
    DEFAULT_CHAN_RADIUS,
    DEFAULT_NUM_SAMPLES,
    DEFAULT_PROBE_RADIUS,
    analyze_frame,
    network,
)
