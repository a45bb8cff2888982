"""
Suffix-enforcing path handling (behavior parity: amof/files/path.py:7-22).
"""

from __future__ import annotations

from pathlib import Path


def append_suffix(path, suffix) -> Path:
    """Append ``suffix`` to ``path`` unless it is already the final suffix.

    Args:
        path: pathlib.Path or string.
        suffix: string; a leading '.' is added if missing.

    Returns:
        pathlib.Path
    """
    dotted = suffix if not suffix or suffix.startswith(".") else f".{suffix}"
    p = Path(path)
    # parent/(name+dotted) instead of with_name: the latter raises for
    # empty-final-component paths (Path('.'), Path('/')) where the
    # reference's string concatenation returns a usable path
    # (amof/files/path.py:7-22).
    return p if p.suffix == dotted else p.parent / (p.name + dotted)
