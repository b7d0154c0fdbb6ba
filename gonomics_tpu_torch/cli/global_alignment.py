"""globalAlignment on the PyTorch port: align two single-record FASTA
files, the counterpart of ``gonomics_tpu/cli/global_alignment.py``.

    python -m gonomics_tpu_torch.cli.global_alignment a.fa b.fa [-faOut f] [--device cpu]
        [--backend auto|tpu|numpy|interpret]

constGap Needleman-Wunsch with the humanChimpTwo matrix and gap penalty
-430 on the card (``--device cpu``, or ``--backend numpy`` or
``interpret`` as the JAX tool takes them, runs the kernels' plain
versions on the CPU);
prints the Go-formatted score and cigar line and the two-row alignment
view, and optionally writes the alignment as FASTA (-faOut), byte for
byte as gonomics' ``cmd/globalAlignment`` does.
"""

from __future__ import annotations

import argparse
import sys

from . import PLAIN_BACKENDS
from .. import fileio
from ..align import HUMAN_CHIMP_TWO, const_gap, go_format, view
from ..io import fasta


def global_alignment(file_one: str, file_two: str, out_file_name: str = "",
                     device=None, out=None) -> None:
    out = sys.stdout if out is None else out
    recs_one = fasta.read(file_one)
    recs_two = fasta.read(file_two)
    if not recs_one or not recs_two:
        raise SystemExit("error, unable to read .fa files")
    if len(recs_one) > 1 or len(recs_two) > 1:
        raise SystemExit(
            f"multiple sequnces detected in .fa files: {len(recs_one)} sequences "
            f"in the first .fa file and {len(recs_two)} sequences in the second "
            ".fa file. This program is designed for .fa files with only 1 "
            "sequence in them")
    fa_one, fa_two = recs_one[0], recs_two[0]

    best_score, aln = const_gap(fa_one.seq, fa_two.seq, HUMAN_CHIMP_TWO, -430,
                                device=device)
    # globalAlignment.go:90-95, byte for byte
    out.write(f"Alignment score is {best_score}, cigar is {go_format(aln)} \n")
    visualize = view(fa_one.seq, fa_two.seq, aln)
    out.write(visualize + "\n")

    if out_file_name:
        rows = visualize.split("\n")
        with fileio.easy_create(out_file_name) as f:
            f.write(f">{fa_one.name}\n{rows[0]}\n>{fa_two.name}\n{rows[1]}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="globalAlignment",
        description="Align 2 .fasta files, each with only 1 sequence")
    p.add_argument("target")
    p.add_argument("query")
    p.add_argument("-faOut", dest="fa_out", default="",
                   help="fasta MSA output filename")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the DP runs; cpu runs the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "tpu", "numpy", "interpret"],
                   help="as the JAX tool takes it: numpy or interpret is "
                        "the caller's choice of the plain PyTorch versions "
                        "on the CPU; any other value runs on --device")
    a = p.parse_args(argv)
    device = "cpu" if a.backend in PLAIN_BACKENDS else a.device
    global_alignment(a.target, a.query, a.fa_out, device=device)


if __name__ == "__main__":
    main()
