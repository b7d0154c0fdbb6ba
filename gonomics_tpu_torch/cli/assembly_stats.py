"""assemblyStats: N50, L50 and the contig counts of an assembly, its
contigs split on N, a copy of ``gonomics_tpu/cli/assembly_stats.py``
(27 lines).

    gonomics-torch assemblyStats in.fa out.txt [-countLowerAsGaps]
"""

from __future__ import annotations

import argparse

from ..io import fasta as fastaio


def assembly_stats_cmd(infile: str, outfile: str,
                       count_lower_as_gaps: bool = False) -> None:
    stats = fastaio.assembly_stats(infile, count_lower_as_gaps)
    fastaio.write_assembly_stats(infile, outfile, *stats)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="assemblyStats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-countLowerAsGaps", action="store_true")
    a = p.parse_args(argv)
    assembly_stats_cmd(a.input, a.output, a.countLowerAsGaps)


if __name__ == "__main__":
    main()
