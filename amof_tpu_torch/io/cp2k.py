"""
CP2K output-file utilities.

CP2K restarts re-emit already-written MD steps, so trajectory (`.xyz`)
and tabular (`.ener`/`.cell`/`.stress`) outputs can contain duplicate
step records and repeated header lines. The helpers here segment each
file into step-keyed records, keep the first occurrence of every step,
and rewrite the file atomically.

Behavior parity: amof/files/cp2k.py (clean_xyz :12-41, clean_tabular
:44-71, read_tabular :74-106) plus the .cell-file parsing embedded in
amof/trajectory.py:208-228. The implementation is record-oriented
(segment -> dedup -> re-emit) rather than the reference's single-pass
write toggle; observable file contents are identical. pandas is imported
only inside ``read_tabular``, so the module imports without it.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# CP2K xyz frame comment, e.g. " i =      100, time =        50.000, E = ..."
_XYZ_STEP_RE = re.compile(r"^ i = \s*(-?\d+),")


def _segment_xyz(lines: Iterable[str]) -> Iterator[Tuple[Optional[int], List[str]]]:
    """Split a CP2K xyz stream into (step, block) records.

    A frame block spans from its atom-count line (the line immediately
    before the ``' i = ...'`` comment) to the line before the next
    frame's atom-count line. Anything before the first frame is yielded
    as a single (None, preamble) record.
    """
    pending: List[str] = []  # lines not yet assigned to a frame
    step: Optional[int] = None
    block: List[str] = []
    for line in lines:
        match = _XYZ_STEP_RE.match(line)
        if match is None:
            pending.append(line)
            continue
        # `pending[-1]` is this frame's atom-count line; everything
        # earlier belongs to the previous record.
        head = pending[-1:]
        tail = pending[:-1]
        if step is None:
            if block or tail:
                yield None, block + tail
        else:
            yield step, block + tail
        step = int(match.group(1))
        block = head + [line]
        pending = []
    if step is None:
        if block or pending:
            yield None, block + pending
    else:
        yield step, block + pending


def _rewrite(filename, records: Iterable[List[str]]) -> None:
    """Atomically replace `filename` with the concatenated records."""
    tmp = str(filename) + "_temp_rm_duplicates"
    with open(tmp, "w") as fw:
        for lines in records:
            fw.writelines(lines)
    os.replace(tmp, str(filename))


def clean_xyz(filename) -> None:
    """Drop repeated-step frames from a CP2K xyz output in place.

    Frames are keyed by the step number in their ``' i = ...'`` comment
    line; only the first occurrence of each step is kept. Streams
    record-by-record (CP2K trajectories are routinely multi-GB; only
    the seen-step set and one frame block are held in memory).
    """
    seen = set()

    def kept_records() -> Iterator[List[str]]:
        with open(filename, "r") as fr:
            for step, block in _segment_xyz(fr):
                if step is not None:
                    if step in seen:
                        logger.info("Removing duplicate %s", step)
                        continue
                    seen.add(step)
                yield block

    _rewrite(filename, kept_records())


def clean_tabular(filename) -> None:
    """Drop repeated headers and repeated-step rows from a CP2K tabular
    output (ener / cell / stress: one '#' header then one row per step)
    in place. The first header line is kept; the step is the FIRST
    whitespace-separated field of each data row. Streams row-by-row."""
    seen = set()

    def kept_rows() -> Iterator[List[str]]:
        with open(filename, "r") as fr:
            yield [fr.readline()]
            for row in fr:
                if row.startswith("#"):
                    continue  # repeated header from a restart
                step = int(row.split()[0])
                if step in seen:
                    logger.info(
                        "Removing duplicate %s", row.rstrip("\n")
                    )
                    continue
                seen.add(step)
                yield [row]

    _rewrite(filename, kept_rows())


def _header_fields(header_line: str) -> List[Tuple[str, str]]:
    """Parse a CP2K tabular header into (column name, unit) pairs.

    Columns are separated by runs of >= 2 spaces (single spaces can
    occur inside a column title); each non-Step column carries its unit
    in brackets, e.g. ``Volume [Ang^3]``.
    """
    cells = re.split(r"\  +", header_line.rstrip("\n"))[1:]  # [0] is '#'
    fields: List[Tuple[str, str]] = []
    for cell in cells:
        if "Step" in cell:
            fields.append(("Step", ""))
            continue
        title, unit = re.search(r"(.*)\[(.*)\]", cell).groups()
        fields.append((title.strip(".").strip(" "), unit))
    return fields


def read_tabular(filename, return_units: bool = False):
    """Parse a CP2K tabular file (ener/cell/stress) into a DataFrame
    indexed by Step; optionally also return {column: unit}."""
    import pandas as pd

    with open(filename, "r") as fr:
        fields = _header_fields(fr.readline())
    names = [name for name, _ in fields]
    df = pd.read_csv(filename, skiprows=1, names=names, sep=r"\s+")
    df = df.set_index("Step")
    if return_units:
        return df, dict(fields)
    return df


def read_cell_file(path_to_cell, index=None):
    """Read a CP2K .cell file into an array of 3x3 cell matrices.

    Column layout: Step, Time, Ax..Cz (9 values), Volume — the slice
    [2:-1] of each row holds the cell matrix (amof/trajectory.py:218-226).
    """
    cell = np.genfromtxt(path_to_cell)
    if len(cell.shape) == 1:  # single frame
        cell = cell[2:-1]
        if index is not None:
            cell = cell[index]
        return np.array([cell.reshape(3, 3)])
    cell = cell[:, 2:-1]
    if index is not None:
        cell = cell[index]
    return np.array([c.reshape(3, 3) for c in cell])
