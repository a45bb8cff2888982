"""Kernel #6, ``surface_valid_columns`` (the pore step's surface-point
blocker test, ``-sa``): the work one frame needs, whatever computes it
(``reference/pore.py`` ``work_counts``).

Bytes: every atom read once (x, y, z and its radius, float32: 16 B),
every direction once (12 B), the channel mask once (1 B a voxel), and for
every atom and direction its validity and the linear indices of its
voxel and of its outward step's voxel written once (1 + 4 + 4 B).
Operations: only the (sphere point, other atom) pairs where the atom
blocks the point (d < R_j + probe - 1e-4), for the points of candidate
atoms (a point, or its step 0.2 A out, on a void voxel of the channel
mask: the points that can count), 18 a pair as in
``void_masks_points.py``. A point needs at least one test to be found
blocked; the kernel tests every staged row up to its first blocker, at
least 16 rows a point."""

from bench_torch.reference import pore as ref_pore

KERNELS = ("surface_columns_kernel",)
OPS_PAIR = 18


def work(out, piece, config, traffic, device="cpu"):
    """(bytes, f32 operations) of the kernel over one unit."""
    c = ref_pore.work_counts(piece, config["elements"], traffic["options"],
                             device)
    n, k = c["atoms"], c["dirs"]
    n_bytes = c["frames"] * (16 * n + 12 * k + c["voxels"] + 9 * n * k)
    return n_bytes, OPS_PAIR * c["surface_pairs"]
