"""bedToFasta: the sequence of each bed region as a FASTA record, a copy
of ``gonomics_tpu/cli/bed_to_fasta.py`` (44 lines), its flags unchanged.

    gonomics-torch bedToFasta ref.fa in.bed out.fa [-revComp]

A record takes its region's name; with ``-revComp`` a region on the
``-`` strand is reverse-complemented and named ``<name>_RevComp``. A
chromosome missing from the FASTA exits "Chrom not found in fasta".
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import bed as bedio
from ..io import fasta as fastaio


def bed_to_fasta(fasta_file: str, bed_file: str, out_file: str,
                 rev_comp: bool = False) -> None:
    records = bedio.read(bed_file)
    ref = {r.name: r for r in fastaio.read(fasta_file)}
    out: list[fastaio.Fasta] = []
    for b in records:
        if b.chrom not in ref:
            raise SystemExit("Chrom not found in fasta")
        entry = fastaio.Fasta(
            b.name, np.asarray(ref[b.chrom].seq[b.chrom_start:b.chrom_end],
                               np.int8).copy())
        if rev_comp and b.strand == bedio.NEGATIVE:
            entry.name = f"{entry.name}_RevComp"
            entry.seq = dna.reverse_complement(entry.seq).astype(np.int8)
        out.append(entry)
    fastaio.write(out_file, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedToFasta")
    p.add_argument("reference")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-revComp", action="store_true")
    a = p.parse_args(argv)
    bed_to_fasta(a.reference, a.input, a.output, a.revComp)


if __name__ == "__main__":
    main()
