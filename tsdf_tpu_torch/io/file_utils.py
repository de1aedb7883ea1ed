"""Small file utilities: port of ``tsdf_tpu/io/file_utils.py``, the
named homes of the reference's FileUtilities."""

from __future__ import annotations

import os
from typing import Callable, Optional


def match_file_name(
    prefix: str, index: int, suffix: str, extension: str, name: str
) -> bool:
    """True if ``name`` is prefix + 5-digit zero-padded index + suffix +
    '.' + extension."""
    return name == f"{prefix}{index:05d}{suffix}.{extension}"


def files_in_directory(
    directory: str, predicate: Optional[Callable[[str], bool]] = None
) -> list[str]:
    """Sorted names of the files in a directory, optionally filtered."""
    names = sorted(
        f
        for f in os.listdir(directory)
        if os.path.isfile(os.path.join(directory, f))
    )
    if predicate is not None:
        names = [f for f in names if predicate(f)]
    return names


def process_file_by_lines(
    path: str, handler: Callable[[str], None]
) -> None:
    """Call ``handler`` on each line, without its newline."""
    with open(path) as f:
        for line in f:
            handler(line.rstrip("\n"))


def read_last_line(path: str) -> Optional[str]:
    """The last non-empty line of a text file, or None."""
    last = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                last = line
    return last


def file_exists(path: str) -> bool:
    return os.path.isfile(path)
