"""alleleSplit: the reads of an F1 hybrid's SAM split by the parental
allele their bases carry; a copy of ``gonomics_tpu/cli/allele_split.py``
(149 lines, whole), gonomics' ``cmd/alleleSplit``.

    gonomics-torch alleleSplit -f1 F -parentOne P1 -parentTwo P2 in.sam
        genotypes.vcf
    gonomics-torch alleleSplit -samples genotypes.vcf

Sites where both parents are homozygous for different alleles and the F1
is heterozygous (ASFilter, toSam.go:13) are looked up at each read's
aligned bases (SnpSearch, toSam.go:21); a read goes to
``<f1>.<parentOne>.SNPs.sam`` or ``<f1>.<parentTwo>.SNPs.sam``, relative
to the working directory, by the larger count, and to neither on a tie.
A deletion counts a parent only where that parent's allele holds exactly
as many gap characters as the deletion is long. ``-samples`` prints the
sample names only for one file ending ``.vcf`` or ``vcf.gz``.

It keeps the JAX tool's two divergences from gonomics, which has no test
of this tool: the allele table is built from the matched record itself
(toSam.go:52 rebuilds it from the previous read's record), and a
deletion that matches parent two counts for parent two (toSam.go:80
counts parent one for both).
"""

from __future__ import annotations

import argparse
import sys

from .. import dna, fileio
from ..io import sam as samio
from ..io import vcf as vcfio


def as_filter(v: vcfio.Vcf, p1: int, p2: int, f1: int) -> bool:
    """ASFilter (toSam.go:13; allele_split.py:30-36): parents homozygous
    for different alleles, F1 heterozygous."""
    s = v.samples
    return (vcfio.is_homozygous(s[p1]) and vcfio.is_homozygous(s[p2])
            and vcfio.is_heterozygous(s[f1])
            and s[p1].alleles[0] != s[p2].alleles[1])


def header_sample_indices(header: vcfio.Header) -> dict[str, int]:
    """{sample name: column} of the #CHROM line (allele_split.py:39-44)."""
    for line in header.text:
        if line.startswith("#CHROM"):
            return {n: i for i, n in enumerate(line.split("\t")[9:])}
    return {}


def print_sample_names(header: vcfio.Header) -> str:
    """The sample names a line (allele_split.py:47-52)."""
    for line in header.text:
        if line.startswith("#CHROM"):
            return "".join(w + "\n" for w in line.split("\t")[9:])
    return ""


def snp_search(sam_file: str, genotype_vcf: str, f_one: str,
               parent_one: str, parent_two: str, prefix: str) -> None:
    """SnpSearch (toSam.go:21; allele_split.py:55-122)."""
    records, vcf_header = vcfio.read(genotype_vcf)
    gidx = header_sample_indices(vcf_header)
    p1, p2, f1 = gidx[parent_one], gidx[parent_two], gidx[f_one]

    # (chrom, 0-based pos) -> (allele seqs, p1 allele idx, p2 allele idx)
    snp_db: dict[tuple[str, int], tuple[list, int, int]] = {}
    for v in records:
        if not as_filter(v, p1, p2, f1):
            continue
        key = (v.chrom, v.pos - 1)
        if key not in snp_db:
            alleles = [dna.from_string(v.ref)] + \
                [dna.from_string(a) for a in v.alt]
            snp_db[key] = (alleles, v.samples[p1].alleles[0],
                           v.samples[p2].alleles[0])

    header, reads = samio.read(sam_file)
    out1 = fileio.easy_create(f"{prefix}.{parent_one}.SNPs.sam")
    out2 = fileio.easy_create(f"{prefix}.{parent_two}.SNPs.sam")
    try:
        for out in (out1, out2):
            for line in header.text:
                out.write(line + "\n")
        for read in reads:
            n1 = n2 = 0
            target = read.pos - 1
            query = 0
            for op in read.cigar:
                if op.op in ("S", "I"):
                    query += op.run_length
                elif op.op == "D":
                    hit = snp_db.get((read.rname, target))
                    if hit is not None:
                        alleles, a1, a2 = hit
                        if dna.count_base(alleles[a1], dna.GAP) \
                                == op.run_length:
                            n1 += 1
                        if dna.count_base(alleles[a2], dna.GAP) \
                                == op.run_length:
                            n2 += 1
                    target += op.run_length
                elif op.op == "M":
                    for j in range(op.run_length):
                        hit = snp_db.get((read.rname, target + j))
                        if hit is None:
                            continue
                        alleles, a1, a2 = hit
                        base = dna.to_upper(read.seq[query + j:
                                                     query + j + 1])
                        for idx, bump in ((a1, 1), (a2, 2)):
                            al = dna.to_upper(alleles[idx])
                            if len(al) == 1 and al[0] == base[0]:
                                if bump == 1:
                                    n1 += 1
                                else:
                                    n2 += 1
                    target += op.run_length
                    query += op.run_length
            if n1 > n2:
                out1.write(read.to_string() + "\n")
            elif n2 > n1:
                out2.write(read.to_string() + "\n")
    finally:
        out1.close()
        out2.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="alleleSplit")
    p.add_argument("-f1", default="",
                   help="F1 hybrid sample name (heterozygous in the VCF)")
    p.add_argument("-samples", action="store_true",
                   help="Print names of samples in the VCF header")
    p.add_argument("-parentOne", default="")
    p.add_argument("-parentTwo", default="")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)

    if a.samples and len(a.files) == 1:
        if a.files[0].endswith(("vcf.gz", ".vcf")):
            _, header = vcfio.read(a.files[0])
            sys.stdout.write(print_sample_names(header))
        return
    if len(a.files) != 2 or (not a.f1 and not a.parentOne) \
            or not a.parentTwo:
        raise SystemExit("Error: unexpected number of arguments...")
    snp_search(a.files[0], a.files[1], a.f1, a.parentOne, a.parentTwo,
               a.f1)


if __name__ == "__main__":
    main()
