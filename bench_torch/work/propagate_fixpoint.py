"""Kernel #7, ``propagate_fixpoint`` (the flood-fill labels of the pore
step's channel/pocket classification): the work one frame needs,
whatever computes it (``reference/pore.py`` ``work_counts``).

A frame takes two fixpoints on the channel mask's grid: the open
components (no periodic wrap), then the channel spread through periodic
connectivity. Bytes: each reads its int32 grid once and writes its int32
labels once (8 B a voxel a pass). Operations: one maximum for every pair
of 6-neighbour void voxels a pass (open faces, then with the periodic
wrap)."""

from bench_torch.reference import pore as ref_pore

KERNELS = ("ff_tiles", "ff_faces", "ff_gather")


def work(out, piece, config, traffic, device="cpu"):
    """(bytes, f32 operations) of the kernel over one unit."""
    c = ref_pore.work_counts(piece, config["elements"], traffic["options"],
                             device)
    return c["frames"] * 2 * 8 * c["voxels"], c["void_faces"]
