from amof_tpu_torch.io.xyz import read_xyz

__all__ = ["read_xyz"]
