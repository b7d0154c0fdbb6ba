"""BedPe (paired-end bed) records, a contact between two feet: a copy of
``gonomics_tpu/io/bedpe.py`` (118 lines; ``BedPe`` and ``to_string``
:12-35, ``process_line`` :38, ``read`` :57, ``write_to_handle`` :65,
``write`` :69, ``contacts_to_midpoints`` :85, ``annotate_feet_dist``
:98, ``BedPeHalf`` :106, ``split_bedpe`` :115).

Fields 7 and later are mirrored into both feet. A strand field is kept
where it is a substring of ``"+-."``, so an empty field or ``+-`` passes
as a strand. The JAX file defines ``annotate_feet_dist`` twice (:76 and
:98); Python binds the second, ``abs(a.start - b.start)``, the one kept
here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

from .. import fileio
from . import bed as bedio


@dataclass
class BedPe:
    a: bedio.Bed = field(default_factory=bedio.Bed)
    b: bedio.Bed = field(default_factory=bedio.Bed)

    def to_string(self, fields: int | None = None) -> str:
        """The record as bedpe.ToString (bedpe.go:36) writes it: the A
        foot's field count, or fields, decides the columns."""
        n = self.a.fields_initialized if fields is None else fields
        if n < 6:
            raise ValueError(f"expecting at least 6 bedPe fields, got {n}")
        out = (f"{self.a.chrom}\t{self.a.chrom_start}\t{self.a.chrom_end}\t"
               f"{self.b.chrom}\t{self.b.chrom_start}\t{self.b.chrom_end}")
        if n >= 7:
            out += f"\t{self.a.name}"
        if n >= 8:
            out += f"\t{self.a.score}"
        if n >= 9:
            out += f"\t{self.a.strand}"
        if n >= 10:
            out += f"\t{self.b.strand}"
        if n >= 11:
            for x in self.a.annotation:
                out += f"\t{x}"
        return out


def process_line(line: str) -> BedPe:
    """One tab-separated line (processBedPeLine, bedpe.go:95): both feet
    take the line's field count, name, score and annotations."""
    w = line.split("\t")
    cur = BedPe(
        bedio.Bed(w[0], int(w[1]), int(w[2]), fields_initialized=len(w)),
        bedio.Bed(w[3], int(w[4]), int(w[5]), fields_initialized=len(w)))
    if len(w) >= 7:
        cur.a.name = cur.b.name = w[6]
    if len(w) >= 8:
        cur.a.score = cur.b.score = int(w[7])
    if len(w) >= 9:
        cur.a.strand = w[8] if w[8] in "+-." else bedio.NONE
    if len(w) >= 10:
        cur.b.strand = w[9] if w[9] in "+-." else bedio.NONE
    if len(w) >= 11:
        cur.a.annotation = list(w[10:])
        cur.b.annotation = list(w[10:])
    return cur


def read(filename: str) -> list[BedPe]:
    """Every non-comment line of a bedpe file."""
    with fileio.easy_open(filename) as f:
        return [process_line(line) for line in fileio.real_lines(f)]


def write_to_handle(f: IO[str], rec: BedPe) -> None:
    f.write(rec.to_string() + "\n")


def write(filename: str, records: list[BedPe]) -> None:
    with fileio.easy_create(filename) as f:
        for r in records:
            write_to_handle(f, r)


def contacts_to_midpoints(records: list[BedPe]) -> None:
    """bedpe.ContactsToMidpoints (modify.go:4): both feet collapse to
    their 1 bp midpoints, their names and scores cleared."""
    for r in records:
        for foot in (r.a, r.b):
            mid = (foot.chrom_start + foot.chrom_end) // 2
            foot.chrom_start = mid
            foot.chrom_end = mid + 1
            foot.name = ""
            foot.score = 0


def annotate_feet_dist(records: list[BedPe]) -> None:
    """bedpe.AnnotateFeetDist (compare.go:33): |A.start - B.start|
    appended to the A foot's annotations, its field count set to 11."""
    for r in records:
        r.a.fields_initialized = 11
        dist = abs(r.a.chrom_start - r.b.chrom_start)
        r.a.annotation.append(str(dist))


@dataclass
class BedPeHalf:
    """One foot and the record it belongs to (bedpe.BedPeHalf)."""
    chrom: str = ""
    chrom_start: int = 0
    chrom_end: int = 0
    home: BedPe | None = None


def split_bedpe(rec: BedPe) -> tuple[BedPeHalf, BedPeHalf]:
    """bedpe.SplitBedPe (bedpe.go:176)."""
    return (BedPeHalf(rec.a.chrom, rec.a.chrom_start, rec.a.chrom_end, rec),
            BedPeHalf(rec.b.chrom, rec.b.chrom_start, rec.b.chrom_end, rec))
