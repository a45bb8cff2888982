"""Share of the pore step's traced units' wall time in which no device
activity ran (1 minus the union of device intervals from
``torch.profiler``)."""


def read(tr):
    return tr.idle_pct()
