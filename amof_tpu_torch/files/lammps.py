"""Compatibility alias for the reference's module path
(amof/files/lammps.py): the LAMMPS utilities live in
amof_tpu_torch.io.lammps."""

from amof_tpu_torch.io.lammps import remove_duplicate_timesteps  # noqa: F401
