"""vcfToFa: a reference FASTA edited with a VCF's substitutions, a
copy of ``gonomics_tpu/cli/vcf_to_fa.py`` (141 lines), its flags
unchanged.

    gonomics-torch vcfToFa in.vcf ref.fa out.fa -useAlt
    gonomics-torch vcfToFa in.vcf aln.fa out.fa -multiFaMode
        -multiFaChromName chr [-useAlt] [-useSamples] [-haploid]

Without ``-multiFaMode`` each record's alt replaces its base in place
(``vcf_to_fa``); with it, edited copies of the alignment's first record
are appended (``vcf_to_multi_fa``): one with the alts under
``-useAlt``, and under ``-useSamples`` one a sample (``-haploid``) or
two, each variant placed at its alignment column. Only biallelic
substitutions are taken; a reference base that differs from the
FASTA's, an unsorted VCF in multiFa mode and no edit option exit.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import fasta as fastaio
from ..io import vcf as vcfio
from .vcf_filter import is_biallelic, is_substitution


def _copy_of_ref(aln: list, name: str) -> None:
    if not aln:
        raise SystemExit("Input fasta must contain at least one record "
                         "in multiFaMode.")
    aln.append(fastaio.Fasta(name, np.array(aln[0].seq, np.int8, copy=True)))


def _base(s: str) -> int:
    return int(dna.from_string(s)[0])


def _update_seq(seqs, aln_pos: int, samples: list, v: vcfio.Vcf,
                offset: int, haploid: bool) -> None:
    """updateSeq (vcfToFa.go:35)."""
    for sample_idx in range(len(samples)):
        alleles = v.samples[sample_idx].alleles
        if not alleles:
            continue
        if alleles[0] > 0:
            seq_idx = offset + (sample_idx if haploid else 2 * sample_idx)
            seqs[seq_idx].seq[aln_pos] = _base(v.alt[alleles[0] - 1])
        if not haploid and alleles[1] > 0:
            seqs[offset + 2 * sample_idx + 1].seq[aln_pos] = \
                _base(v.alt[alleles[1] - 1])


def vcf_to_multi_fa(vcf_file: str, fa_file: str, out_file: str,
                    chrom_name: str, use_alt: bool, use_samples: bool,
                    haploid: bool) -> None:
    """vcfToMultiFa (vcfToFa.go:62): variants placed at alignment
    positions with respect to gaps; appends edited copies of seq 0."""
    if not chrom_name:
        raise SystemExit("Must specify a chrom name when using multiFa mode.")
    records, header = vcfio.read(vcf_file)
    meta = vcfio.parse_header_meta(header)
    seqs = fastaio.read(fa_file)
    for s in seqs:
        s.seq = np.array(s.seq, np.int8, copy=True)
    alt_seq_idx = 0
    if use_alt:
        _copy_of_ref(seqs, seqs[0].name + "alt")
        alt_seq_idx = len(seqs) - 1
    offset = len(seqs)
    if use_samples:
        for name in meta.samples:
            _copy_of_ref(seqs, name)
            if not haploid:
                _copy_of_ref(seqs, name + "_secondAllele")
    first, prev_pos = True, 0
    prev_ref_pos = prev_aln_pos = 0
    for v in records:
        if first and v.chrom == chrom_name:
            first = False
            prev_pos = v.pos
        elif v.pos <= prev_pos and v.chrom == chrom_name:
            raise SystemExit("Input VCF variants must be in sorted order "
                             "in multiFaMode.")
        if not (is_biallelic(v) and is_substitution(v)):
            raise SystemExit("Error: currently we only handle biallelic "
                             "substitutions.")
        if v.chrom != chrom_name:
            continue
        aln_pos = fastaio.ref_pos_to_aln_pos_counter(
            seqs[0], v.pos - 1, prev_ref_pos, prev_aln_pos)
        if int(seqs[0].seq[aln_pos]) != _base(v.ref):
            raise SystemExit("Error: base in fasta didn't match ref base "
                             "from VCF record.")
        if use_alt:
            seqs[alt_seq_idx].seq[aln_pos] = _base(v.alt[0])
        if use_samples:
            _update_seq(seqs, aln_pos, meta.samples, v, offset, haploid)
        prev_ref_pos = v.pos - 1
        prev_aln_pos = aln_pos
    fastaio.write(out_file, seqs)


def vcf_to_fa(vcf_file: str, fa_file: str, out_file: str,
              use_alt: bool) -> None:
    """vcfToFa (vcfToFa.go:130): in-place substitution edits."""
    seqs = fastaio.read(fa_file)
    for s in seqs:
        s.seq = np.array(s.seq, np.int8, copy=True)
    lookup = {s.name: s.seq for s in seqs}
    records, _ = vcfio.read(vcf_file)
    for v in records:
        if not (is_biallelic(v) and is_substitution(v)):
            raise SystemExit("Error: currently we only handle biallelic "
                             "substitutions")
        if int(lookup[v.chrom][v.pos - 1]) != _base(v.ref):
            raise SystemExit("Error: base in fasta didn't match ref base "
                             "from VCF record")
        if use_alt:
            lookup[v.chrom][v.pos - 1] = _base(v.alt[0])
    fastaio.write(out_file, seqs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfToFa")
    p.add_argument("vcf")
    p.add_argument("fasta")
    p.add_argument("output")
    p.add_argument("-useAlt", action="store_true")
    p.add_argument("-useSamples", action="store_true")
    p.add_argument("-multiFaMode", action="store_true")
    p.add_argument("-multiFaChromName", default="")
    p.add_argument("-haploid", action="store_true")
    a = p.parse_args(argv)
    if not (a.useAlt or a.useSamples):
        raise SystemExit("Error: you must use at least one option or the "
                         "fasta file will have no edits")
    if a.multiFaMode:
        vcf_to_multi_fa(a.vcf, a.fasta, a.output, a.multiFaChromName,
                        a.useAlt, a.useSamples, a.haploid)
    else:
        vcf_to_fa(a.vcf, a.fasta, a.output, a.useAlt)


if __name__ == "__main__":
    main()
