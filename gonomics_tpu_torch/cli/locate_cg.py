"""locateCG: the CpG sites of a sequence, or of two aligned sequences
the CpG sites gained, lost or kept, a copy of
``gonomics_tpu/cli/locate_cg.py`` (93 lines), its flags and defaults
unchanged.

    gonomics-torch locateCG in.fa chromName out.bed
    gonomics-torch locateCG aln.fa chromName out.txt -compare
        -cgtype gain|loss|cons

In ``-compare`` mode the positions are record 0's reference
coordinates (``fasta.aln_pos_to_ref_pos_counter``); RefEnd and AlnEnd
are written one past the pair's second base (locate_cg.py:70-72).
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio


def locate_cg(in_fa: str, chrom: str, out_file: str) -> None:
    f = fastaio.read(in_fa)
    if len(f) != 1:
        raise SystemExit(f"Error: expecting exactly one record in fasta "
                         f"file, but got {len(f)}.")
    seq = np.asarray(f[0].seq)
    if len(seq) == 0:
        raise SystemExit("Error: fasta sequence is empty.")
    hits = np.nonzero((seq[:-1] == dna.C) & (seq[1:] == dna.G))[0]
    bedio.write(out_file, [
        bedio.Bed(chrom=chrom, chrom_start=int(i), chrom_end=int(i) + 2,
                  fields_initialized=3) for i in hits])


def compare_cg(in_fa: str, chrom: str, out_file: str, cg_type: str) -> None:
    f = fastaio.read(in_fa)
    if len(f) != 2:
        raise SystemExit(f"Error: --compare mode expects exactly two "
                         f"sequences in fasta, but got {len(f)}")
    first, second = np.asarray(f[0].seq), np.asarray(f[1].seq)
    if len(first) == 0 or len(second) == 0:
        raise SystemExit("Missing or empty sequences for seq1 or seq2.")
    if len(first) != len(second):
        raise SystemExit("Seq1 and seq2 not equal in length.")

    rows = []
    ref_start = aln_start = 0
    both = dna.define_base_mask(first) & dna.define_base_mask(second)
    for i in range(len(first) - 1):
        if not (both[i] and both[i + 1]):
            continue
        f1, f2 = int(first[i]), int(first[i + 1])
        s1, s2 = int(second[i]), int(second[i + 1])
        first_cg = f1 == dna.C and f2 == dna.G
        second_cg = s1 == dna.C and s2 == dna.G
        hit = ((cg_type == "cons" and first_cg and second_cg)
               or (cg_type == "gain" and first_cg and not second_cg)
               or (cg_type == "loss" and not first_cg and second_cg))
        if hit:
            start = fastaio.aln_pos_to_ref_pos_counter(
                f[0], i, ref_start, aln_start)
            ref = dna.to_string(np.array([f1, f2], np.int8))
            alt = dna.to_string(np.array([s1, s2], np.int8))
            rows.append((chrom, start, start + 1, cg_type, ref, alt,
                         i, i + 1))
        if rows:
            ref_start, aln_start = rows[-1][1], rows[-1][6]
    with fileio.easy_create(out_file) as out:
        out.write("Chrom\tRefStart\tRefEnd\tType\tRef\tAlt\tAlnStart\t"
                  "AlnEnd\n")
        for r in rows:
            out.write(f"{r[0]}\t{r[1]}\t{r[2] + 1}\t{r[3]}\t{r[4]}\t{r[5]}"
                      f"\t{r[6]}\t{r[7] + 1}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="locateCG")
    p.add_argument("input")
    p.add_argument("chromName")
    p.add_argument("output")
    p.add_argument("-compare", action="store_true")
    p.add_argument("-cgtype", default="")
    a = p.parse_args(argv)
    if a.compare:
        if a.cgtype not in ("gain", "loss", "cons"):
            raise SystemExit("Error: Must specify --cgtype in --compare "
                             "mode: 'gain', 'loss', 'cons'.")
        compare_cg(a.input, a.chromName, a.output, a.cgtype)
    else:
        locate_cg(a.input, a.chromName, a.output)


if __name__ == "__main__":
    main()
