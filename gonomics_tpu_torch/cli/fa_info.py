"""faInfo: the counts of A, T, C, G, gaps and N in each record, a copy
of ``gonomics_tpu/cli/fa_info.py`` (42 lines), its flags and defaults
unchanged.

    gonomics-torch faInfo in.fa [-outFile stdout]

Any other character, lower case included, exits (fa_info.py:19-26).
The default ``-outFile`` is a file named ``stdout``, as in the JAX tool.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import fasta as fastaio


def fa_info(in_file: str, out_file: str) -> None:
    records = fastaio.read(in_file)
    counted = (dna.A, dna.T, dna.C, dna.G, dna.GAP, dna.N)
    totals = np.zeros(6, dtype=np.int64)
    with fileio.easy_create(out_file) as out:
        out.write("#Name\tA\tT\tC\tG\tGap\tN\n")
        for rec in records:
            seq = np.asarray(rec.seq)
            counts = np.array([(seq == b).sum() for b in counted])
            if counts.sum() != len(seq):
                bad = seq[~np.isin(seq, counted)][0]
                raise SystemExit(
                    f"Character '{dna.to_string(np.array([bad]))}' "
                    "encountered in the fasta. This is an illegal "
                    "character.")
            totals += counts
            out.write(rec.name + "\t" + "\t".join(map(str, counts)) + "\n")
        out.write("total\t" + "\t".join(map(str, totals)) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faInfo")
    p.add_argument("input")
    p.add_argument("-outFile", default="stdout")
    a = p.parse_args(argv)
    fa_info(a.input, a.outFile)


if __name__ == "__main__":
    main()
