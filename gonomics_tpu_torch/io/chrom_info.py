"""Chromosome name and size records (mirrors
``gonomics_tpu/io/chrom_info.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from .. import fileio


@dataclass(frozen=True)
class ChromInfo:
    name: str
    size: int
    order: int = 0


def read_to_slice(filename: str) -> list[ChromInfo]:
    """The records of a .sizes file, in file order (chrom_info.py:17)."""
    with fileio.easy_open(filename) as f:
        words = [ln.split() for ln in fileio.real_lines(f)]
    return [ChromInfo(w[0], int(w[1]), i) for i, w in enumerate(words)]
