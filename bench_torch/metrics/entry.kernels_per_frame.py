"""Device kernel launches a frame (all: the port's and PyTorch's) in the
traced units of the per-analysis entry points."""


def read(tr):
    return tr.kernels_per_frame()
