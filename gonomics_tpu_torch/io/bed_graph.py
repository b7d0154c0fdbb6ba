"""BedGraph records, reading and writing: a copy of
``gonomics_tpu/io/bed_graph.py`` (45 lines), which ``bedGraphToWig``
reads. A record is a chrom, a half-open range and one float value,
written as Go's ``%g``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import IO

from .. import fileio
from .wig import go_fmt_g


@dataclass
class BedGraph:
    chrom: str = ""
    chrom_start: int = 0
    chrom_end: int = 0
    data_value: float = 0.0

    def to_string(self) -> str:
        """The record's four tab-separated fields (bedGraph.go:23)."""
        return (f"{self.chrom}\t{self.chrom_start}\t{self.chrom_end}\t"
                f"{go_fmt_g(self.data_value)}")


def process_line(line: str) -> BedGraph:
    w = line.split("\t")
    return BedGraph(w[0], int(w[1]), int(w[2]), float(w[3]))


def read(filename: str) -> list[BedGraph]:
    """Every non-comment line of a bedGraph file."""
    out: list[BedGraph] = []
    with fileio.easy_open(filename) as f:
        for line in fileio.real_lines(f):
            out.append(process_line(line))
    return out


def write_to_handle(f: IO[str], rec: BedGraph) -> None:
    f.write(rec.to_string() + "\n")


def write(filename: str, records: list[BedGraph]) -> None:
    with fileio.easy_create(filename) as f:
        for r in records:
            write_to_handle(f, r)
