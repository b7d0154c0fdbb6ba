"""formatIdeogram: UCSC Genome Graphs ideogram points from a bed; a
copy of ``gonomics_tpu/cli/format_ideogram.py`` (36 lines, whole),
gonomics' ``cmd/formatIdeogram``. Each region becomes three points:
midpoint - 1 and midpoint + 1 at score 1, the midpoint at the bed's
score (or 10 with ``--noScore``)."""

from __future__ import annotations

import argparse

from .. import fileio


def format_ideogram(in_bed: str, out_txt: str, *,
                    no_score: bool = False) -> None:
    with fileio.easy_create(out_txt) as out:
        for line in fileio.read(in_bed):
            words = line.split("\t")
            chrom = words[0]
            midpoint = (int(words[1]) + int(words[2])) // 2
            score = 10 if no_score else int(words[4])
            out.write(f"{chrom}\t{midpoint - 1}\t1\n")
            out.write(f"{chrom}\t{midpoint}\t{score}\n")
            out.write(f"{chrom}\t{midpoint + 1}\t1\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="formatIdeogram")
    p.add_argument("--noScore", action="store_true")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    format_ideogram(a.input, a.output, no_score=a.noScore)


if __name__ == "__main__":
    main()
