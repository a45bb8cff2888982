"""Device kernel launches a frame (all: the port's and PyTorch's) in the
traced units of the fused step on flexible-cell pieces."""


def read(tr):
    return tr.kernels_per_frame()
