"""bedToAminoAcid: the amino acids that the DNA of each bed region codes
for, one three-letter name a line, a copy of
``gonomics_tpu/cli/bed_to_amino_acid.py`` (36 lines), its arguments
unchanged.

    gonomics-torch bedToAminoAcid in.bed ref.fa out.txt

Every region is read from the FASTA file's first record whatever its
chromosome (bed_to_amino_acid.py:15-18), and a partial last codon is
dropped.
"""

from __future__ import annotations

import argparse

from .. import codon, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio


def bed_to_amino_acid(bed_file: str, fasta_file: str, output: str) -> None:
    records = bedio.read(bed_file)
    ref = fastaio.read(fasta_file)[0]
    lines: list[str] = []
    for b in records:
        seq = ref.seq[b.chrom_start:b.chrom_end]
        aas = codon.translate_seq(seq)
        lines.extend(codon.AA_LONG[a] for a in aas)
    with fileio.easy_create(output) as out:
        for ln in lines:
            out.write(ln + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedToAminoAcid")
    p.add_argument("bed")
    p.add_argument("fasta")
    p.add_argument("output")
    a = p.parse_args(argv)
    bed_to_amino_acid(a.bed, a.fasta, a.output)


if __name__ == "__main__":
    main()
