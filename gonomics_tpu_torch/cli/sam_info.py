"""samInfo: the read-length, coverage and MAPQ histograms of a SAM or BAM
file; a copy of ``gonomics_tpu/cli/sam_info.py`` (148 lines), its
subcommands, flags and defaults unchanged.

    gonomics-torch samInfo readLength in.sam out.txt
    gonomics-torch samInfo coverage in.sam hist.txt stats.txt
        [-highEndFilter 0.001]
    gonomics-torch samInfo mapq in.sam out.txt [-bedfile regions.bed]

``readLength``'s histogram has at least 200 rows and grows to n + 10
past a longer read. ``coverage`` runs the host ``pileup.pileup``; its
histogram has at least 30 rows, Lambda is written as Go's ``%v``, and an
``Expected`` row (``:.6g``) only where its log lies in (-745.1, 709.4).
``-countNinDepth`` is ``store_true`` with default True, so it cannot be
turned off. ``mapq`` appends MAPQ values above 60 in the order it first
meets them; ``-bedfile`` seeks each region on its own in a BAM with its
``.bai`` beside it, so a read in two regions counts twice.
"""

from __future__ import annotations

import argparse
import math
import sys

from .. import dna, fileio, pileup
from ..fileio import go_v
from ..io import bai as baiio
from ..io import bed as bedio
from ..io import sam as samio


def read_length(in_file: str, out_file: str) -> None:
    _header, records = samio.read(in_file)
    hist = [0] * 200
    for s in records:
        n = len(s.seq)
        if n >= len(hist):
            hist.extend([0] * (n + 10 - len(hist)))
        hist[n] += 1
    with fileio.easy_create(out_file) as out:
        out.write("ReadLength\tCount\n")
        for i, count in enumerate(hist):
            out.write(f"{i}\t{count}\n")


def _total_depth(p: pileup.Pile, count_n: bool) -> int:
    """A, C, G and T on both strands, with N where count_n."""
    depth = int(p.count_f[:4].sum() + p.count_r[:4].sum())
    if count_n:
        depth += int(p.count_f[dna.N] + p.count_r[dna.N])
    return depth


def coverage(sam_file: str, hist_out: str, stats_out: str, *,
             count_n_in_depth: bool = True,
             high_end_filter: float = 0.001) -> None:
    header, records = samio.read(sam_file)
    piles = pileup.pileup(records, header)
    hist = [0] * 30
    total = 0
    for p in piles:
        depth = _total_depth(p, count_n_in_depth)
        if depth >= len(hist):
            hist.extend([0] * (depth + 10 - len(hist)))
        hist[depth] += 1
        total += 1
    bins = sum(hist)
    lam = sum(i * c for i, c in enumerate(hist)) / bins
    # the coverage below which all but high_end_filter of the positions lie
    target = total - total * high_end_filter
    observations = float(total)
    index = len(hist) - 1
    while observations > target:
        observations -= hist[index]
        index -= 1
    with fileio.easy_create(stats_out) as out:
        out.write(f"Lambda\t{go_v(lam)}\nCoverageThreshold\t{index}\n")
    with fileio.easy_create(hist_out) as out:
        out.write("Coverage\tPileups\tGroup\tFilename\n")
        for i, pileups in enumerate(hist):
            out.write(f"{i}\t{pileups}\tEmpirical\t{sam_file}\n")
            log_p = (i * math.log(lam) - lam
                     - math.lgamma(i + 1)) if lam > 0 else float("-inf")
            if -745.1 < log_p < 709.4:
                out.write(f"{i}\t{math.exp(log_p) * total:.6g}\t"
                          f"Expected\t{sam_file}\n")


def mapq(in_file: str, out_file: str, bed_regions: str = "") -> None:
    hist = [0] * 61
    other: list[int] = []

    def add(s: samio.Sam) -> None:
        if samio.is_unmapped_flag(s):
            return
        if s.mapq > 60:
            if s.mapq in other:
                hist[61 + other.index(s.mapq)] += 1
            else:
                other.append(s.mapq)
                hist.append(1)
        else:
            hist[s.mapq] += 1

    if bed_regions:
        bai = baiio.read_bai(in_file + ".bai")
        for b in bedio.read(bed_regions):
            for s in baiio.seek_bam_region(in_file, bai, b.chrom,
                                           b.chrom_start, b.chrom_end):
                add(s)
    else:
        _h, records = samio.read(in_file)
        for s in records:
            add(s)
    with fileio.easy_create(out_file) as out:
        out.write("mapQ\tcount\n")
        for i, count in enumerate(hist):
            key = i if i < 61 else other[i - 61]
            out.write(f"{key}\t{count}\n")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("Error: user must specify a samInfo subcommand.")
    sub, rest = argv[0], argv[1:]
    if sub == "readLength":
        p = argparse.ArgumentParser(prog="samInfo readLength")
        p.add_argument("input")
        p.add_argument("output")
        a = p.parse_args(rest)
        read_length(a.input, a.output)
    elif sub == "coverage":
        p = argparse.ArgumentParser(prog="samInfo coverage")
        p.add_argument("input")
        p.add_argument("histogram")
        p.add_argument("stats")
        p.add_argument("-countNinDepth", action="store_true",
                       default=True)
        p.add_argument("-highEndFilter", type=float, default=0.001)
        a = p.parse_args(rest)
        coverage(a.input, a.histogram, a.stats,
                 count_n_in_depth=a.countNinDepth,
                 high_end_filter=a.highEndFilter)
    elif sub == "mapq":
        p = argparse.ArgumentParser(prog="samInfo mapq")
        p.add_argument("input")
        p.add_argument("output")
        p.add_argument("-bedfile", default="")
        a = p.parse_args(rest)
        mapq(a.input, a.output, a.bedfile)
    else:
        raise SystemExit(f"Error: unrecognized subcommand: {sub}.")


if __name__ == "__main__":
    main()
