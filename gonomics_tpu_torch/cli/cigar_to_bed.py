"""cigarToBed on the PyTorch port: affine-gap align two single-record
FASTA files and write the insertions and deletions as beds; the
counterpart of ``gonomics_tpu/cli/cigar_to_bed.py``.

    python -m gonomics_tpu_torch.cli.cigar_to_bed a.fa b.fa
        [-insBedOut f] [-delBedOut f] [-faOut f] [--device cpu] [--backend b]

affineGap -600/-150 with the humanChimpTwo matrix on the card
(``--device cpu``, or ``--backend numpy`` or ``interpret`` as the JAX
tool takes them, runs the kernels' plain versions on the CPU).

Parity note: gonomics' deletion pass re-uses the insertion condition
(M followed by I, cigarToBed.go:121); it is reproduced verbatim so that
the beds match byte for byte."""

from __future__ import annotations

import argparse
import sys

from . import PLAIN_BACKENDS
from .. import dna, fileio
from ..align import COL_D, COL_I, COL_M, HUMAN_CHIMP_TWO, affine_gap
from ..align import go_format, view
from ..io import bed as bedio
from ..io import fasta as fastaio


def cigar_to_bed(file_one: str, file_two: str, *, out_fa: str = "",
                 ins_bed_out: str = "ins.bed", del_bed_out: str = "del.bed",
                 first_pos_ins: int = 1, first_pos_del: int = 1,
                 chrom: str = "chr1", device=None, out=None) -> None:
    out = sys.stdout if out is None else out
    recs_one, recs_two = fastaio.read(file_one), fastaio.read(file_two)
    if not recs_one or not recs_two:
        raise SystemExit("error, unable to read .fa files")
    if len(recs_one) > 1 or len(recs_two) > 1:
        raise SystemExit("multiple sequnces detected in .fa files")
    fa_one, fa_two = recs_one[0], recs_two[0]
    fa_one.seq = dna.to_upper(fa_one.seq)
    fa_two.seq = dna.to_upper(fa_two.seq)

    best_score, aln = affine_gap(fa_one.seq, fa_two.seq, HUMAN_CHIMP_TWO,
                                 -600, -150, device=device)
    out.write(f"Using AffineGap, Alignment score is {best_score}, cigar "
              f"is {go_format(aln)} \n")

    with fileio.easy_create(ins_bed_out) as ins:
        current = first_pos_ins - 1
        for i in range(len(aln) - 1):
            if aln[i].op == COL_M and aln[i + 1].op == COL_I:
                start = current + aln[i].run_length + 1
                bedio.write_to_handle(ins, bedio.Bed(
                    chrom=chrom, chrom_start=start,
                    chrom_end=start + aln[i + 1].run_length, name="ins",
                    fields_initialized=4))
            if aln[i].op != COL_D:
                current += aln[i].run_length

    with fileio.easy_create(del_bed_out) as dl:
        current = first_pos_del - 1
        for i in range(len(aln) - 1):
            if aln[i].op == COL_M and aln[i + 1].op == COL_I:
                start = current + aln[i].run_length
                bedio.write_to_handle(dl, bedio.Bed(
                    chrom=chrom, chrom_start=start, chrom_end=start + 1,
                    name="del", fields_initialized=4))
            if aln[i].op != COL_I:
                current += aln[i].run_length

    visualize = view(fa_one.seq, fa_two.seq, aln)
    out.write(visualize + "\n")
    if out_fa:
        rows = visualize.split("\n")
        with open(out_fa, "w") as f:
            f.write(f">{fa_one.name}\n{rows[0]}\n"
                    f">{fa_two.name}\n{rows[1]}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="cigarToBed")
    p.add_argument("target")
    p.add_argument("query")
    p.add_argument("-faOut", default="")
    p.add_argument("-insBedOut", default="ins.bed")
    p.add_argument("-delBedOut", default="del.bed")
    p.add_argument("-FirstPos_Ins", type=int, default=1)
    p.add_argument("-FirstPos_Del", type=int, default=1)
    p.add_argument("-Chr", default="chr1")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the DP runs; cpu runs the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--backend", default="auto",
                   help="as the JAX tool takes it: numpy or interpret is "
                        "the caller's choice of the plain PyTorch versions "
                        "on the CPU; any other value runs on --device")
    a = p.parse_args(argv)
    device = "cpu" if a.backend in PLAIN_BACKENDS else a.device
    cigar_to_bed(a.target, a.query, out_fa=a.faOut,
                 ins_bed_out=a.insBedOut, del_bed_out=a.delBedOut,
                 first_pos_ins=a.FirstPos_Ins, first_pos_del=a.FirstPos_Del,
                 chrom=a.Chr, device=device)


if __name__ == "__main__":
    main()
