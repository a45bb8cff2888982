"""Share of the traced units' wall time in which no device activity ran
(1 minus the union of device intervals from ``torch.profiler``), on
flexible-cell pieces."""


def read(tr):
    return tr.idle_pct()
