"""BED records, reading, writing and the region algebra: the parts of
``gonomics_tpu/io/bed.py`` that ``cigarToBed``, ``samToBed``,
``faFormat``, ``bedMerge``, ``bedToWig``, ``intervalOverlap``,
``mergesort``, ``bedFormat`` and the bed tools use, with the strand
constants that bedToFasta reads (``POSITIVE``, ``NEGATIVE``, ``NONE``
:14, ``Bed`` :18, ``process_bed_line`` :45, ``read`` :60,
``write_to_handle`` :64, ``write`` :68, ``compare`` :74,
``sort_by_coord`` :85, ``overlap`` :93,
``minimum_distance`` :111, ``merge_high_mem`` :122,
``merge_beds_keep_names_and_annotations`` :147-165, which
geneAssignmentStats merges its truth with), and the
``to_midpoint`` and ``to_tss`` trims (:179-195) that bedFormat uses.
Field-count-aware formatting matches gonomics' ``bed.ToString``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

from .. import fileio

POSITIVE, NEGATIVE, NONE = "+", "-", "."  # NONE: strand not given


@dataclass
class Bed:
    chrom: str = ""
    chrom_start: int = 0
    chrom_end: int = 0
    name: str = ""
    score: int = 0
    strand: str = NONE
    fields_initialized: int = 3
    annotation: list[str] = field(default_factory=list)

    def to_string(self, fields: int | None = None) -> str:
        n = self.fields_initialized if fields is None else fields
        if n < 3:
            raise ValueError(f"expecting at least 3 bed fields, got {n}")
        out = f"{self.chrom}\t{self.chrom_start}\t{self.chrom_end}"
        if n >= 4:
            out += f"\t{self.name}"
        if n >= 5:
            out += f"\t{self.score}"
        if n >= 6:
            out += f"\t{self.strand}"
        if n >= 7:
            for a in self.annotation:
                out += f"\t{a}"
        return out


def process_bed_line(line: str) -> Bed:
    """One tab-separated line; the fields it has are the fields it
    writes back."""
    w = line.split("\t")
    b = Bed(chrom=w[0], chrom_start=int(w[1]), chrom_end=int(w[2]),
            fields_initialized=len(w))
    if len(w) >= 4:
        b.name = w[3]
    if len(w) >= 5:
        b.score = int(w[4])
    if len(w) >= 6:
        b.strand = w[5] if w[5] in "+-." else NONE
    if len(w) >= 7:
        b.annotation = w[6:]
    return b


def read(filename: str) -> list[Bed]:
    """Every non-empty, non-comment line of a bed file."""
    return [process_bed_line(ln) for ln in fileio.read(filename) if ln]


def write_to_handle(f: IO[str], b: Bed) -> None:
    f.write(b.to_string() + "\n")


def write(filename: str, records: list[Bed]) -> None:
    with fileio.easy_create(filename) as f:
        for b in records:
            write_to_handle(f, b)


def compare(a: Bed, b: Bed) -> int:
    """-1, 0 or 1 as a sorts before, with or after b: by chrom (as
    strings), then start, then end (bed.Compare, compare.go:160)."""
    if a.chrom != b.chrom:
        return -1 if a.chrom < b.chrom else 1
    if a.chrom_start != b.chrom_start:
        return -1 if a.chrom_start < b.chrom_start else 1
    if a.chrom_end != b.chrom_end:
        return -1 if a.chrom_end < b.chrom_end else 1
    return 0


def sort_by_coord(records: list[Bed]) -> None:
    records.sort(key=lambda b: (b.chrom, b.chrom_start, b.chrom_end))


def overlap(a: Bed, b: Bed) -> bool:
    return (a.chrom == b.chrom
            and max(a.chrom_start, b.chrom_start)
            < min(a.chrom_end, b.chrom_end))


def minimum_distance(a: Bed, b: Bed) -> int | None:
    """bed.MinimumDistance; None for different chromosomes, 0 for
    overlapping records, and one more than the bases between them
    otherwise."""
    if a.chrom != b.chrom:
        return None
    if overlap(a, b):
        return 0
    if a.chrom_start - b.chrom_end >= 0:
        return a.chrom_start - b.chrom_end + 1
    return b.chrom_start - a.chrom_end + 1


def merge_high_mem(records: list[Bed], merge_adjacent: int = -1,
                   keep_all_names: bool = False) -> list[Bed]:
    """bed.MergeHighMem: sorted copies merged greedily where they overlap
    or lie within merge_adjacent, keeping the highest score (and, with
    keep_all_names, the names joined by commas)."""
    if not records:
        return records
    records = [Bed(**vars(b)) for b in records]
    sort_by_coord(records)
    out: list[Bed] = []
    cur = records[0]
    for b in records[1:]:
        dist = minimum_distance(cur, b)
        if overlap(cur, b) or (dist is not None and dist <= merge_adjacent):
            if b.score > cur.score:
                cur.score = b.score
            cur.chrom_end = max(b.chrom_end, cur.chrom_end)
            if keep_all_names and b.name:
                cur.name = f"{cur.name},{b.name}" if cur.name else b.name
        else:
            out.append(cur)
            cur = b
    out.append(cur)
    return out


def merge_beds_keep_names_and_annotations(records: list[Bed]) -> list[Bed]:
    """records sorted, then each overlapping neighbour merged into the
    record before it (bed.MergeBedsKeepNamesAndAnnotations,
    compare.go:49): the names joined by commas, the scores summed, and
    the first annotation appended once again for each merge, as gonomics
    does. Sorts and edits records in place and returns them."""
    sort_by_coord(records)
    i = 0
    while i < len(records) - 1:
        if not overlap(records[i], records[i + 1]):
            i += 1
        else:
            records[i].chrom_start = min(records[i].chrom_start,
                                         records[i + 1].chrom_start)
            records[i].chrom_end = max(records[i].chrom_end,
                                       records[i + 1].chrom_end)
            records[i].score += records[i + 1].score
            records[i].name += "," + records[i + 1].name
            records[i].annotation.append(records[i].annotation[0])
            del records[i + 1]
    return records


def to_midpoint(b: Bed) -> Bed:
    """A copy of b cut to its one midpoint base, (start + end) // 2."""
    out = Bed(**vars(b))
    mid = (b.chrom_start + b.chrom_end) // 2
    out.chrom_start = mid
    out.chrom_end = mid + 1
    return out


def to_tss(b: Bed) -> Bed:
    """A copy of b cut to its first base on its strand; ValueError for a
    record without + or - strand."""
    out = Bed(**vars(b))
    if b.strand == POSITIVE:
        out.chrom_end = b.chrom_start + 1
    elif b.strand == NEGATIVE:
        out.chrom_start = b.chrom_end - 1
    else:
        raise ValueError("bed must have +/- strand for Tss")
    return out
