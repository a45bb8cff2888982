"""
Basic file operations: gzip compress/decompress/concatenate.

Behavior parity: amof/files/operation.py:13-47.
"""

from __future__ import annotations

import gzip
import logging
from pathlib import Path
from shutil import copyfileobj

logger = logging.getLogger(__name__)


def _stream(open_src, open_dst) -> None:
    """Copy between files given as zero-arg openers, so the source handle
    is closed deterministically even when opening the destination fails."""
    with open_src() as f_in:
        with open_dst() as f_out:
            copyfileobj(f_in, f_out)


def _gz_sibling(plain: Path) -> Path:
    """``plain`` with '.gz' appended; built via parent/(name+'.gz') so
    empty-final-component paths keep the reference's behavior
    (amof/files/operation.py:13-47 uses string concatenation)."""
    return plain.parent / (plain.name + ".gz")


def compress(filename, remove_if_exists: bool = False) -> None:
    """Gzip ``filename`` to ``filename + '.gz'`` and remove the original.

    If ``remove_if_exists`` and the .gz already exists, only the original
    is removed (same as the reference).
    """
    plain = Path(str(filename))
    packed = _gz_sibling(plain)
    if not (remove_if_exists and packed.exists()):
        logger.info("compress %s", plain)
        _stream(lambda: plain.open("rb"), lambda: gzip.open(packed, "wb"))
    plain.unlink()


def decompress(filename, remove: bool = True) -> None:
    """Gunzip ``filename + '.gz'`` to ``filename``."""
    plain = Path(str(filename))
    packed = _gz_sibling(plain)
    logger.info("decompress %s", plain)
    _stream(lambda: gzip.open(packed, "rb"), lambda: plain.open("wb"))
    if remove:
        packed.unlink()


def concatenate(filenames, output_file) -> None:
    """Concatenate ``filenames`` (bytes) into ``output_file``."""
    with open(output_file, "wb") as out:
        for name in filenames:
            with open(name, "rb") as part:
                copyfileobj(part, out)
