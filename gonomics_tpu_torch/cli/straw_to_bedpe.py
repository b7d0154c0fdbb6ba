"""strawToBedpe: significant contacts of HiC straw maps as bedpe; a copy
of ``gonomics_tpu/cli/straw_to_bedpe.py`` (182 lines, whole), gonomics'
``cmd/strawToBedpe/strawToBedpe.go``.

    gonomics-torch strawToBedpe fileList.txt out.bedpe [-binSize 5000]
        [-fitStatsFile fit.txt] [-contactScoreFile scores.txt] ...

Each line of the file list is a straw file and its chrom, tab-separated;
each straw file is read twice. The contact scores at each bin distance
are fitted to a zero-truncated negative binomial (coordinate ascent,
``numbers/fit.py``), and a contact is written where its score passes the
Benjamini-Hochberg cutoff of its distance. The cutoffs stop at the first
distance whose cutoff stays at ``-minCutoff``; a distance with no
contacts fits ``[0]``; the comparison counts may go negative; the score
histogram's header is followed by a blank line. A distance that is not
a multiple of ``-binSize`` exits.
"""

from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass

from .. import fileio
from ..io import bedpe as bedpeio, hic
from ..io.bed import Bed
from ..numbers.distributions import negative_binomial_cdf
from ..numbers.fit import zero_truncated_negative_binomial


@dataclass
class Settings:
    file_list: str
    out_file: str
    bin_size: int = 5000
    r_start: float = 1.0
    p_start: float = 0.5
    r_step: float = 0.001
    p_step: float = 0.001
    min_cutoff: int = 10
    min_bin_distance: int = 0
    fdr: float = 0.05
    contact_score_file: str = ""
    max_contact_score_in_distribution_file: int = 100
    max_bin_distance_in_distribution_file: int = -1
    fit_stats_file: str = ""


def _bin_distance(straw: hic.Straw, bin_size: int) -> int:
    dist = abs(straw.bin1_start - straw.bin2_start)
    if dist % bin_size != 0:
        raise SystemExit(f"Error: Distance between two straw ends: {dist} "
                         f"is not a multiple of the bin size: {bin_size}.")
    return dist // bin_size


def _print_contact_scores(cache: list[list[int]], s: Settings) -> None:
    """printContactScoreCacheToFile (strawToBedpe.go:160): the reference
    prints the header with an extra newline."""
    with fileio.easy_create(s.contact_score_file) as out:
        out.write("BinDistance\tScore\tCount\n\n")
        for d in range(s.max_bin_distance_in_distribution_file):
            row = cache[d] if d < len(cache) and cache[d] is not None else []
            for score in range(s.max_contact_score_in_distribution_file):
                count = row[score] if score < len(row) else 0
                out.write(f"{d}\t{score}\t{count}\n")


def _comparison_counts(cache, mins, maxes, s: Settings) -> list[int]:
    """makeComparisonCountCache (strawToBedpe.go:185)."""
    out = []
    for i in range(len(cache)):
        total = 0
        for key in mins:
            total += (maxes[key] - mins[key]) // s.bin_size - i
        out.append(total)
    return out


def _bh_cutoffs(cache, s: Settings, comparisons) -> list[int]:
    """calculateBenjamaniHochbergCutoff (strawToBedpe.go:201)."""
    cutoffs = [s.min_cutoff] * len(cache)
    out = None
    if s.fit_stats_file:
        out = fileio.easy_create(s.fit_stats_file)
        out.write("BinDistance\tR\tP\tCutoff\n")
    for d in range(s.min_bin_distance, len(cache)):
        rank = 0
        row = cache[d] if cache[d] is not None else [0]
        r, p = zero_truncated_negative_binomial(row, s.r_start, s.p_start,
                                                s.r_step, s.p_step)
        for score in range(len(row) - 1, s.min_cutoff, -1):
            rank += row[score]
            q = ((1 - negative_binomial_cdf(float(score), r, p))
                 * comparisons[d] / rank) if rank else math.nan
            if not math.isnan(q) and not math.isinf(q) and q > s.fdr:
                cutoffs[d] = score
                break
        if out is not None:
            out.write(f"{d}\t{fileio.go_v(r)}\t{fileio.go_v(p)}\t"
                      f"{cutoffs[d]}\n")
        if cutoffs[d] == s.min_cutoff:
            break
    if out is not None:
        out.close()
    return cutoffs


def straw_to_bedpe(s: Settings) -> None:
    cache: list[list[int] | None] = [[0], [0]]
    mins: dict[str, int] = {}
    maxes: dict[str, int] = {}
    lines = fileio.read(s.file_list)
    for line in lines:
        path, chrom = line.split("\t")[:2]
        for straw in hic.read_to_iter(path):
            lo = min(straw.bin1_start, straw.bin2_start)
            hi = max(straw.bin1_start, straw.bin2_start)
            mins[chrom] = min(mins.get(chrom, lo), lo)
            maxes[chrom] = max(maxes.get(chrom, hi), hi)
            d = _bin_distance(straw, s.bin_size)
            while d > len(cache) - 1:
                cache.append(None)
            if cache[d] is None:
                cache[d] = [0]
            if straw.contact_score > len(cache[d]) - 1:
                cache[d] = cache[d] + [0] * (straw.contact_score + 1
                                             - len(cache[d]))
            cache[d][straw.contact_score] += 1

    if s.contact_score_file:
        if s.max_bin_distance_in_distribution_file == -1:
            s.max_bin_distance_in_distribution_file = len(cache)
        _print_contact_scores(cache, s)

    comparisons = _comparison_counts(cache, mins, maxes, s)
    cutoffs = _bh_cutoffs(cache, s, comparisons)

    with fileio.easy_create(s.out_file) as out:
        for line in lines:
            path, chrom = line.split("\t")[:2]
            for straw in hic.read_to_iter(path):
                d = _bin_distance(straw, s.bin_size)
                if d >= s.min_bin_distance and \
                        straw.contact_score > cutoffs[d]:
                    rec = bedpeio.BedPe(
                        a=Bed(chrom=chrom, chrom_start=straw.bin1_start,
                              chrom_end=straw.bin1_start + s.bin_size,
                              score=straw.contact_score,
                              fields_initialized=8),
                        b=Bed(chrom=chrom, chrom_start=straw.bin2_start,
                              chrom_end=straw.bin2_start + s.bin_size,
                              score=straw.contact_score,
                              fields_initialized=8))
                    bedpeio.write_to_handle(out, rec)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="strawToBedpe")
    p.add_argument("fileList")
    p.add_argument("out")
    p.add_argument("-binSize", type=int, default=5000)
    p.add_argument("-rStart", type=float, default=1.0)
    p.add_argument("-pStart", type=float, default=0.5)
    p.add_argument("-rStep", type=float, default=0.001)
    p.add_argument("-pStep", type=float, default=0.001)
    p.add_argument("-fdr", type=float, default=0.05)
    p.add_argument("-minCutoff", type=int, default=10)
    p.add_argument("-fitStatsFile", default="")
    p.add_argument("-minBinDistance", type=int, default=0)
    p.add_argument("-contactScoreFile", default="")
    p.add_argument("-maxContactScoreInDistributionFile", type=int,
                   default=100)
    p.add_argument("-maxBinDistanceInDistributionFile", type=int,
                   default=-1)
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    straw_to_bedpe(Settings(
        file_list=a.fileList, out_file=a.out, bin_size=a.binSize,
        r_start=a.rStart, p_start=a.pStart, r_step=a.rStep, p_step=a.pStep,
        min_cutoff=a.minCutoff, min_bin_distance=a.minBinDistance,
        fdr=a.fdr, contact_score_file=a.contactScoreFile,
        max_contact_score_in_distribution_file=(
            a.maxContactScoreInDistributionFile),
        max_bin_distance_in_distribution_file=(
            a.maxBinDistanceInDistributionFile),
        fit_stats_file=a.fitStatsFile))


if __name__ == "__main__":
    main()
