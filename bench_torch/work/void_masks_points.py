"""Kernel #5, ``void_masks_points`` (the pore step's probe and channel
voxel masks and its Monte Carlo points' fits): the work one frame needs,
whatever computes it (``reference/pore.py`` ``work_counts``).

Bytes: every atom read once (x, y, z and its radius, float32: 16 B),
every MC point once (12 B), each voxel mask written once (1 B a voxel;
one mask where the probe and channel radii are equal), each point's fit
written once (1 B). Operations: only the (voxel centre, atom) pairs where
the atom blocks the centre (d < R_j + chan) and the (MC point, atom)
pairs where it blocks the point (d < R_j + probe), 18 a pair: the
fractional separation (3 subtractions), its minimum image (3 roundings,
3 subtractions), Cartesian in an orthorhombic cell (3 products), squared
and summed (3 products, 2 sums) and compared with (R_j + r)^2 (1). The
kernel's factorized quadratic takes fewer a pair, but tests every row of
its window, far more pairs than these."""

from bench_torch.reference import pore as ref_pore

KERNELS = ("void_masks_kernel",)
OPS_PAIR = 18


def work(out, piece, config, traffic, device="cpu"):
    """(bytes, f32 operations) of the kernel over one unit."""
    c = ref_pore.work_counts(piece, config["elements"], traffic["options"],
                             device)
    n_bytes = c["frames"] * (16 * c["atoms"] + 13 * c["points"]
                             + c["masks"] * c["voxels"])
    return n_bytes, OPS_PAIR * (c["mask_pairs"] + c["fit_pairs"])
