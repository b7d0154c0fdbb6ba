"""HiC straw (juicer) contact records; a copy of ``gonomics_tpu/io/hic.py``
(57 lines, whole), gonomics' ``hic/hic.go``. Read-only, as in the
reference.

A record is three tab fields read with ``int()``, so a float score
raises ValueError; ``#`` lines are skipped only before the first
record, so a ``#`` line after it raises too."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

from .. import fileio


@dataclass
class Straw:
    bin1_start: int = 0
    bin2_start: int = 0
    contact_score: int = 0


def process_straw_line(line: str) -> Straw:
    """processStrawLine (hic.go:41)."""
    w = line.split("\t")
    return Straw(int(w[0]), int(w[1]), int(w[2]))


def read_to_iter(filename: str) -> Iterator[Straw]:
    """hic.GoReadToChan analog: stream Straw records.

    Mirrors hic.Read (hic.go:31): only the FIRST line uses the
    comment-skipping reader (EasyNextRealLine); after that every line is
    taken verbatim (EasyNextLine), so a mid-file '#' line is parsed (and
    fails) rather than silently skipped."""
    with fileio.easy_open(filename) as f:
        first = fileio.next_real_line(f)
        if first is None:
            return
        yield process_straw_line(first)
        for line in f:
            yield process_straw_line(line.rstrip("\n"))


def read(filename: str) -> list[Straw]:
    """hic.Read (hic.go:23)."""
    return list(read_to_iter(filename))


def equal(a: Straw, b: Straw) -> bool:
    """hic.Equal (hic.go:53): bin order-insensitive."""
    if a.contact_score != b.contact_score:
        return False
    return (a.bin1_start, a.bin2_start) in (
        (b.bin1_start, b.bin2_start), (b.bin2_start, b.bin1_start))


def all_are_equal(a: list[Straw], b: list[Straw]) -> bool:
    if len(a) != len(b):
        raise ValueError("straw slices are not of equal length")
    return all(equal(x, y) for x, y in zip(a, b))
