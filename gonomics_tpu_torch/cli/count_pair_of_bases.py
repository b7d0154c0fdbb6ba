"""countPairOfBases: the count of one pair of adjacent bases (CG, say)
in a sequence or its bed regions, or in two aligned sequences the pairs
gained, lost and kept, a copy of ``gonomics_tpu/cli/count_pair_of_bases.py``
(161 lines), its flags and defaults unchanged.

    gonomics-torch countPairOfBases in.fa chrom C G out.txt [-bed r.bed]
        [-compare]

With ``-compare -bed`` the regions are in record 0's reference
coordinates, moved to alignment columns with
``fasta.ref_pos_to_aln_pos_counter``; a gap after a pair's first base is
skipped to the next base or N.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio


def _count_pair(seq: np.ndarray, b1: int, b2: int) -> int:
    """countPairOfBasesHelper (countPairOfBases.go:122)."""
    if len(seq) == 0:
        raise SystemExit("Error: fasta sequence is empty.")
    return int(((seq[:-1] == b1) & (seq[1:] == b2)).sum())


def _next_base(region: np.ndarray, pos: int) -> int:
    """nextBase (countPairOfBases.go:53): skip gaps to next base or N."""
    for i in range(pos, len(region)):
        b = int(region[i])
        if dna.define_base_mask(b) or b == dna.N:
            return b
    return dna.GAP


def _compare_counts(first: np.ndarray, second: np.ndarray, b1: int,
                    b2: int) -> tuple[int, int, int]:
    """comparePairOfBaseCount (countPairOfBases.go:149)."""
    gain = loss = cons = 0
    for i in range(len(first) - 1):
        f1, s1 = int(first[i]), int(second[i])
        if f1 != b1 and s1 != b1:
            continue
        f2, s2 = int(first[i + 1]), int(second[i + 1])
        if f2 == dna.GAP and f1 != dna.GAP:
            f2 = _next_base(first, i + 1)
        if s2 == dna.GAP and s1 != dna.GAP:
            s2 = _next_base(second, i + 1)
        first_pair = f1 == b1 and f2 == b2
        second_pair = s1 == b1 and s2 == b2
        if first_pair and second_pair:
            cons += 1
        elif first_pair and s1 != dna.N and s2 != dna.N:
            gain += 1
        elif second_pair and s1 != dna.N and s2 != dna.N and not first_pair:
            loss += 1
    return gain, loss, cons


def _ref_to_aln_bed(regions: list[bedio.Bed], aln) -> list[bedio.Bed]:
    """RefPosToAlnPosBed (countPairOfBases.go:66)."""
    out: list[bedio.Bed] = []
    ref_seq = aln[0]
    last_ref = last_aln = 0
    for i, region in enumerate(regions):
        if not region.name:
            raise SystemExit("Error: each BED region must have a name in "
                             "column 4")
        if i == 0:
            start = fastaio.ref_pos_to_aln_pos(ref_seq, region.chrom_start)
            end = fastaio.ref_pos_to_aln_pos(ref_seq, region.chrom_end)
        else:
            start = fastaio.ref_pos_to_aln_pos_counter(
                ref_seq, region.chrom_start, last_ref, last_aln)
            end = fastaio.ref_pos_to_aln_pos_counter(
                ref_seq, region.chrom_end, last_ref, last_aln)
        out.append(bedio.Bed(chrom=region.chrom, chrom_start=start,
                             chrom_end=end, name=region.name,
                             fields_initialized=4))
        last_ref, last_aln = region.chrom_end, end
    return out


def count_pair_of_bases(in_fa: str, chrom: str, base_one: str,
                        base_two: str, out_file: str, *,
                        bed_file: str = "", compare: bool = False) -> None:
    if len(base_one) != 1 or len(base_two) != 1:
        raise SystemExit("Error: Enter one DNA base for 'base one' and one "
                         "DNA base for 'base two'.")
    b1 = int(dna.from_string(base_one.strip())[0])
    b2 = int(dna.from_string(base_two.strip())[0])
    records = fastaio.read(in_fa)
    with fileio.easy_create(out_file) as out:
        if not compare:
            if len(records) != 1:
                raise SystemExit("Error: expecting exactly one record in "
                                 f"fasta file, but got {len(records)}.")
            seq = np.asarray(records[0].seq)
            if not bed_file:
                out.write("Chrom\tPairOfBasesCount\n")
                out.write(f"{chrom}\t{_count_pair(seq, b1, b2)}\n")
            else:
                out.write("Chrom\tStart\tEnd\tName\tPairOfBasesCount\n")
                for region in bedio.read(bed_file):
                    if region.chrom != chrom:
                        raise SystemExit("Error: Chromosome in BED region "
                                         "does not match.")
                    if (region.chrom_start > len(seq)
                            or region.chrom_end > len(seq)):
                        raise SystemExit("Error: BED region outside of "
                                         "chromosome.")
                    n = _count_pair(
                        seq[region.chrom_start:region.chrom_end], b1, b2)
                    out.write(f"{region.chrom}\t{region.chrom_start}\t"
                              f"{region.chrom_end}\t{region.name}\t{n}\n")
            return
        if len(records) != 2:
            raise SystemExit("Error: expecting exactly two records in "
                             f"fasta file, but got {len(records)}.")
        first, second = np.asarray(records[0].seq), np.asarray(
            records[1].seq)
        if not bed_file:
            gain, loss, cons = _compare_counts(first, second, b1, b2)
            out.write("Chrom\tGain\tLoss\tCons\n")
            out.write(f"{chrom}\t{gain}\t{loss}\t{cons}\n")
            return
        regions = bedio.read(bed_file)
        for region in regions:
            if region.chrom != chrom:
                raise SystemExit("Error: Chromosome in BED region does "
                                 "not match.")
        by_name = {r.name: r for r in regions}
        out.write("Chrom\tStart\tEnd\tName\tGain\tLoss\tCons\n")
        for aln_region in _ref_to_aln_bed(regions, records):
            if (aln_region.chrom_start > len(first)
                    or aln_region.chrom_end > len(first)):
                raise SystemExit("Error: BED region outside of chromosome.")
            sl = slice(aln_region.chrom_start, aln_region.chrom_end)
            gain, loss, cons = _compare_counts(first[sl], second[sl],
                                               b1, b2)
            ref = by_name[aln_region.name]
            out.write(f"{ref.chrom}\t{ref.chrom_start}\t{ref.chrom_end}\t"
                      f"{ref.name}\t{gain}\t{loss}\t{cons}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="countPairOfBases")
    p.add_argument("fastaFile")
    p.add_argument("chromName")
    p.add_argument("baseOne")
    p.add_argument("baseTwo")
    p.add_argument("outfileName")
    p.add_argument("-bed", default="")
    p.add_argument("-compare", action="store_true")
    a = p.parse_args(argv)
    count_pair_of_bases(a.fastaFile, a.chromName, a.baseOne, a.baseTwo,
                        a.outfileName, bed_file=a.bed, compare=a.compare)


if __name__ == "__main__":
    main()
