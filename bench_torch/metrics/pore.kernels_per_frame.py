"""Device kernel launches a frame (all: the port's and PyTorch's) in the
traced units of the pore step (``pore_records``)."""


def read(tr):
    return tr.kernels_per_frame()
