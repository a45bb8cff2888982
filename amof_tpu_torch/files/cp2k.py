"""Compatibility alias for the reference's module path
(amof/files/cp2k.py): the CP2K cleaners/parsers live in
amof_tpu_torch.io.cp2k."""

from amof_tpu_torch.io.cp2k import clean_tabular, clean_xyz, read_tabular  # noqa: F401
