"""faBin: whole FASTA records into bins, a file a bin, a copy of
``gonomics_tpu/cli/fa_bin.py`` (43 lines), its flags and defaults
unchanged.

    gonomics-torch faBin in.fa outDir [-binNum 1] [-minSize -1]
        [-assembly name]

A bin of one record is named after it, a bin of several
``<assembly>.bin<i>.fa`` (``fasta.bin_genome_no_breaks``).
"""

from __future__ import annotations

import argparse
import os

from ..io import fasta as fastaio


def fa_bin(genome: str, path: str, bin_num: int, min_size: int,
           assembly_name: str) -> None:
    records = fastaio.read(genome)
    bins = fastaio.bin_genome_no_breaks(records, bin_num, min_size)
    for i in range(len(bins)):
        recs = bins.get(i, [])
        if not recs:
            continue
        if len(recs) == 1:
            name = recs[0].name
        else:
            assembly = os.path.basename(genome)
            assembly = assembly[:-3] if assembly.endswith(".fa") else assembly
            if assembly == "stdin":
                assembly = assembly_name
            name = f"{assembly}.bin{i}"
        fastaio.write(f"{path}/{name}.fa", recs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faBin")
    p.add_argument("input")
    p.add_argument("path")
    p.add_argument("-minSize", type=int, default=-1)
    p.add_argument("-binNum", type=int, default=1)
    p.add_argument("-assembly", default="")
    a = p.parse_args(argv)
    fa_bin(a.input, a.path, a.binNum, a.minSize, a.assembly)


if __name__ == "__main__":
    main()
