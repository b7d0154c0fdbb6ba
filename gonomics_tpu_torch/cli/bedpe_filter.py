"""bedpeFilter: bedpe contacts that pass bounds on score, distance,
start and chromosome; a copy of ``gonomics_tpu/cli/bedpe_filter.py`` (69
lines), its flags and defaults unchanged.

    gonomics-torch bedpeFilter in.bedpe out.bedpe [-minScore n]
        [-maxScore n] [-minDistance n] [-maxDistance n] [-minStart n]
        [-maxStart n] [-chrom c] [-onlyInterChrom | -onlyIntraChrom]

The distance is |A.start - B.start|, whatever the chromosomes. The start
test drops a record only when both feet start outside [minStart,
maxStart]; ``-chrom`` keeps a record with either foot on it.
"""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..io import bedpe as bedpeio

MAX_INT = sys.maxsize


def bedpe_filter(in_file: str, out_file: str, *, min_score: int = -MAX_INT,
                 max_score: int = MAX_INT, min_distance: int = 0,
                 max_distance: int = MAX_INT, min_start: int = 0,
                 max_start: int = MAX_INT, chrom: str = "",
                 only_inter_chrom: bool = False,
                 only_intra_chrom: bool = False) -> None:
    if max_start <= min_start:
        raise SystemExit("Max Start must be greater than Min Start")
    if only_intra_chrom and only_inter_chrom:
        raise SystemExit("Cannot set both onlyIntraChrom and "
                         "onlyInterChrom")
    out = fileio.easy_create(out_file)
    for cur in bedpeio.read(in_file):
        distance = abs(cur.a.chrom_start - cur.b.chrom_start)
        passes = (min_score <= cur.a.score <= max_score
                  and min_distance <= distance <= max_distance)
        if (cur.a.chrom_start < min_start or cur.a.chrom_start > max_start) \
                and (cur.b.chrom_start < min_start
                     or cur.b.chrom_start > max_start):
            passes = False
        if only_intra_chrom and cur.a.chrom != cur.b.chrom:
            passes = False
        if only_inter_chrom and cur.a.chrom == cur.b.chrom:
            passes = False
        if chrom and cur.a.chrom != chrom and cur.b.chrom != chrom:
            passes = False
        if passes:
            bedpeio.write_to_handle(out, cur)
    out.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedpeFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-minScore", type=int, default=-MAX_INT)
    p.add_argument("-maxScore", type=int, default=MAX_INT)
    p.add_argument("-minDistance", type=int, default=0)
    p.add_argument("-maxDistance", type=int, default=MAX_INT)
    p.add_argument("-minStart", type=int, default=0)
    p.add_argument("-maxStart", type=int, default=MAX_INT)
    p.add_argument("-chrom", default="")
    p.add_argument("-onlyInterChrom", action="store_true")
    p.add_argument("-onlyIntraChrom", action="store_true")
    a = p.parse_args(argv)
    bedpe_filter(a.input, a.output, min_score=a.minScore,
                 max_score=a.maxScore, min_distance=a.minDistance,
                 max_distance=a.maxDistance, min_start=a.minStart,
                 max_start=a.maxStart, chrom=a.chrom,
                 only_inter_chrom=a.onlyInterChrom,
                 only_intra_chrom=a.onlyIntraChrom)


if __name__ == "__main__":
    main()
