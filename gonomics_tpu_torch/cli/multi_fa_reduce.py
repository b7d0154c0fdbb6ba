"""multiFaReduce: a multiFa cut to its variable columns; a copy of
``gonomics_tpu/cli/multi_fa_reduce.py`` (57 lines).

    gonomics-torch multiFaReduce in.fa out.fa [-bedFilename out.bed
        -chrom c [-refStart 0]]

A column is kept where any record differs from the first, N and gaps
included (``fasta.segregating_columns``). With ``-bedFilename`` each
kept column also gets a one-base bed record at its reference position +
``-refStart``, named by the column's bases joined by ``_`` and scored by
the column's index + ``-refStart``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import bed as bedio
from ..io import fasta as fastaio


def segregating_sites_with_bed(aln, chrom: str, ref_start: int):
    """The variable columns and a bed record a column (bed.SegregatingSites,
    bedFasta.go:37)."""
    cols = fastaio.segregating_columns(aln)
    answer_fa = [fastaio.Fasta(r.name, np.asarray(r.seq)[cols]) for r in aln]
    beds = []
    for i in cols:
        ref_pos = fastaio.aln_pos_to_ref_pos(aln[0], int(i))
        name = "_".join(dna.to_string(np.asarray(r.seq)[i:i + 1])
                        for r in aln)
        beds.append(bedio.Bed(chrom=chrom, chrom_start=ref_start + ref_pos,
                              chrom_end=ref_start + ref_pos + 1, name=name,
                              score=ref_start + int(i),
                              fields_initialized=5))
    return answer_fa, beds


def mfa_reduce(in_file: str, out_file: str, bed_file: str = "",
               chrom: str = "", ref_start: int = 0) -> None:
    aln = fastaio.read(in_file)
    if bed_file:
        answer, beds = segregating_sites_with_bed(aln, chrom, ref_start)
        bedio.write(bed_file, beds)
    else:
        answer = fastaio.segregating_sites_fasta(aln)
    fastaio.write(out_file, answer)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaReduce")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-bedFilename", default="")
    p.add_argument("-chrom", default="")
    p.add_argument("-refStart", type=int, default=0)
    a = p.parse_args(argv)
    if a.bedFilename and not a.chrom:
        raise SystemExit("Error: using -bedFilename without -chrom")
    mfa_reduce(a.input, a.output, a.bedFilename, a.chrom, a.refStart)


if __name__ == "__main__":
    main()
