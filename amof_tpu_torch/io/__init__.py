from amof_tpu_torch.io.xyz import read_xyz, write_xyz

__all__ = ["read_xyz", "write_xyz"]
