"""bedpeOverlap: bedpe contacts that overlap a select file; a copy of
``gonomics_tpu/cli/bedpe_overlap.py`` (156 lines).

    gonomics-torch bedpeOverlap select.bedpe in.bedpe out.bedpe
    gonomics-torch bedpeOverlap -bedSelect [-overlapThreshold x]
        [-overlapBoth] [-keepNames] select.bed in.bedpe out.bedpe

With a bedpe select, an input record is written where a select record's
two feet overlap the two feet of one input record; what is written is
the record of the last A-side hit visited, which need not be the pair
that matched. With ``-bedSelect`` a record is kept where its A foot, or
else its B foot, overlaps the bed (``-overlapBoth``: both feet); a
threshold compares the overlap with the foot's own length. On the B
side the reference never marks a hit found, so a record is written once
for every B-side overlap that passes the threshold. ``-keepNames``
writes 7 fields, the A name the overlapping names joined by commas.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..interval import IntervalIndex
from ..io import bed as bedio
from ..io import bedpe as bedpeio


def _overlap_percent(entry, half: bedio.Bed) -> float:
    size = max(0, min(entry.chrom_end, half.chrom_end)
               - max(entry.chrom_start, half.chrom_start))
    return size / (half.chrom_end - half.chrom_start)


def _names(overlaps) -> str:
    return ",".join(o.name for o in overlaps)


def _keep_names(cur: bedpeio.BedPe, overlaps) -> None:
    cur.a.fields_initialized = 7
    cur.b.fields_initialized = 7
    cur.a.name = _names(overlaps)


def select_is_bed(select_file: str, in_file: str, threshold: float,
                  out_file: str, keep_names: bool) -> None:
    """SelectIsBed (bedpeOverlap.go:49): a record whose A foot, or else
    whose B foot, overlaps the select bed."""
    select = bedio.read(select_file)
    if keep_names and select[0].name == "":
        raise SystemExit("keepNames set but select bed has no name field")
    tree = IntervalIndex(select)
    out = fileio.easy_create(out_file)
    for cur in bedpeio.read(in_file):
        overlaps = tree.query(cur.a, "any")
        if overlaps:
            if threshold == 0:
                if keep_names:
                    _keep_names(cur, overlaps)
                bedpeio.write_to_handle(out, cur)
            else:
                found = False
                for j in overlaps:
                    if not found and _overlap_percent(j, cur.a) >= threshold:
                        found = True
                        if keep_names:
                            _keep_names(cur, overlaps)
                        bedpeio.write_to_handle(out, cur)
            continue
        overlaps = tree.query(cur.b, "any")
        if overlaps:
            if threshold == 0:
                if keep_names:
                    _keep_names(cur, overlaps)
                bedpeio.write_to_handle(out, cur)
            else:
                for j in overlaps:  # found is never set on this side
                    if _overlap_percent(j, cur.b) >= threshold:
                        if keep_names:
                            _keep_names(cur, overlaps)
                        bedpeio.write_to_handle(out, cur)
    out.close()


def select_is_bed_both(select_file: str, in_file: str, threshold: float,
                       out_file: str) -> None:
    """SelectIsBedBoth (bedpeOverlap.go:147): both feet must overlap."""
    tree = IntervalIndex(bedio.read(select_file))
    out = fileio.easy_create(out_file)
    for cur in bedpeio.read(in_file):
        a_over = tree.query(cur.a, "any")
        if not a_over:
            continue
        if threshold == 0:
            if tree.query(cur.b, "any"):
                bedpeio.write_to_handle(out, cur)
        else:
            found = False
            for j in a_over:
                if not found and _overlap_percent(j, cur.a) >= threshold:
                    for k in tree.query(cur.b, "any"):
                        if not found and \
                                _overlap_percent(k, cur.b) >= threshold:
                            found = True
                            bedpeio.write_to_handle(out, cur)
    out.close()


def select_is_bedpe(select_file: str, in_file: str, out_file: str) -> None:
    """SelectIsBedPe (bedpeOverlap.go:196): a select record whose feet
    hit the two feet of one input record writes the record of the last
    A-side hit visited."""
    halves: list = []
    for rec in bedpeio.read(in_file):
        halves.extend(bedpeio.split_bedpe(rec))
    tree = IntervalIndex(halves)
    out = fileio.easy_create(out_file)
    for sel in bedpeio.read(select_file):
        left_overlaps = tree.query(sel.a, "any")
        right_overlaps = tree.query(sel.b, "any")
        found = False
        left_half = None
        for lh in left_overlaps:
            for rh in right_overlaps:
                left_half = lh
                if lh.home is rh.home:
                    found = True
        if found:
            bedpeio.write_to_handle(out, left_half.home)
    out.close()


def bedpe_overlap(select_file: str, in_file: str, out_file: str, *,
                  bed_select: bool = False, threshold: float = 0.0,
                  overlap_both: bool = False,
                  keep_names: bool = False) -> None:
    if bed_select and overlap_both:
        select_is_bed_both(select_file, in_file, threshold, out_file)
    elif bed_select:
        select_is_bed(select_file, in_file, threshold, out_file, keep_names)
    else:
        select_is_bedpe(select_file, in_file, out_file)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedpeOverlap")
    p.add_argument("select")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-bedSelect", action="store_true")
    p.add_argument("-overlapThreshold", type=float, default=0.0)
    p.add_argument("-overlapBoth", action="store_true")
    p.add_argument("-keepNames", action="store_true")
    a = p.parse_args(argv)
    if not 0 <= a.overlapThreshold <= 1:
        raise SystemExit("overlap threshold must be between 0 and 1")
    if a.overlapThreshold != 0 and not a.bedSelect:
        raise SystemExit("overlapThreshold must be used with bedSelect")
    if a.overlapBoth and not a.bedSelect:
        raise SystemExit("overlapBoth must be used with bedSelect")
    bedpe_overlap(a.select, a.input, a.output, bed_select=a.bedSelect,
                  threshold=a.overlapThreshold, overlap_both=a.overlapBoth,
                  keep_names=a.keepNames)


if __name__ == "__main__":
    main()
