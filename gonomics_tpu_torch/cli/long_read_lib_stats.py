"""longReadLibStats: the read count and N50 of a long-read FASTQ; a copy
of ``gonomics_tpu/cli/long_read_lib_stats.py`` (43 lines), its flags and
defaults unchanged.

    gonomics-torch longReadLibStats in.fq out.txt [-readLengths lens.txt]

``-readLengths`` lists each read's length in input order. The N50 is
taken from the lengths sorted in descending order at half the total by
``io/fasta.calculate_n50_l50``, which walks that list from its end, the
shortest read: where the sum lands on half the total exactly, the N50 is
the shorter read's length.
"""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..io import fastq as fastqio
from ..io.fasta import calculate_n50_l50


def long_read_lib_stats(in_fq: str, out_file: str,
                        read_lengths: str = "") -> None:
    lens: list[int] = []
    tot = 0
    lenout = fileio.easy_create(read_lengths) if read_lengths else None
    for read in fastqio.read(in_fq):
        tot += len(read.seq)
        lens.append(len(read.seq))
        if lenout is not None:
            lenout.write(f"{len(read.seq)}\n")
    lens.sort(reverse=True)
    n50, _ = calculate_n50_l50(lens, tot // 2)
    with fileio.easy_create(out_file) as out:
        out.write(f"Total number of reads: {len(lens)}\n")
        out.write(f"N50: {n50}\n")
    if lenout is not None:
        lenout.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="longReadLibStats")
    p.add_argument("inFq")
    p.add_argument("outStats")
    p.add_argument("-readLengths", default="")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    long_read_lib_stats(a.inFq, a.outStats, a.readLengths)


if __name__ == "__main__":
    main()
