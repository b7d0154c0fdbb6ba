"""multiFaToVcf: the variants of a pairwise or three-way multiFa
alignment as VCF records, a copy of ``gonomics_tpu/cli/multi_fa_to_vcf.py``
(194 lines), its flags unchanged.

    gonomics-torch multiFaToVcf aln.fa chromName out.vcf
        [-substitutionsOnly] [-retainN] [-secondQueryName name]

Two records go through the state machine of convert.PairwiseFaToVcf
(``pairwise_fa_to_vcf``): the first record is the reference, positions
are its own, an insertion or deletion is written where it closes
(unless ``-substitutionsOnly``), a substitution beside a gap only with
``-substitutionsOnly``, and one with an N only with ``-retainN``.
Three records go through ``three_way_fa_to_vcf``, a genotype a column;
``-secondQueryName`` pairs the first record with the named one.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import fasta as fastaio
from ..io import vcf as vcfio


def _emit(out, chr_, pos, ref, alt):
    v = vcfio.Vcf(chrom=chr_, pos=pos, id=".", ref=ref, alt=[alt],
                  qual=100.0, filter="PASS", info=".", format=["."])
    vcfio.write_vcf(out, v)


def _b2s(x) -> str:
    return dna.to_string(np.atleast_1d(np.asarray(x, "int8")))


def pairwise_fa_to_vcf(f, chr_: str, out, substitutions_only: bool,
                       retain_n: bool) -> None:
    """Literal state machine of convert.PairwiseFaToVcf
    (multi_fa_to_vcf.py:19-109)."""
    if len(f) != 2:
        raise SystemExit("PairwiseFaToVcf expects a fasta input with two "
                         "entries.")
    ref, alt = f[0], f[1]
    a2r = fastaio.aln_pos_to_ref_pos_counter
    past_start = insertion = deletion = False
    ins_pos = del_pos = 0
    curr_ref = curr_aln = 0
    n = len(ref.seq)

    for i in range(n):
        r, q = int(ref.seq[i]), int(alt.seq[i])
        if r == dna.GAP:
            if past_start:
                if not insertion:
                    ins_pos = i - 1
                insertion = True
        elif r != q:
            past_start = True
            if insertion and not substitutions_only:
                curr_ref = a2r(ref, ins_pos, curr_ref, curr_aln)
                curr_aln = ins_pos
                _emit(out, chr_, curr_ref + 1, _b2s(ref.seq[ins_pos]),
                      _b2s(alt.seq[ins_pos:i]))
            if q == dna.GAP:
                if not deletion:
                    del_pos = i - 1
                deletion = True
            elif deletion:
                deletion = False
                if not substitutions_only:
                    curr_ref = a2r(ref, del_pos, curr_ref, curr_aln)
                    curr_aln = del_pos
                    _emit(out, chr_, curr_ref + 1, _b2s(ref.seq[del_pos:i]),
                          _b2s(alt.seq[del_pos]))
                if r == dna.N or q == dna.N:
                    if retain_n:
                        curr_ref = a2r(ref, i, curr_ref, curr_aln)
                        curr_aln = i
                        _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
                else:
                    curr_ref = a2r(ref, i, curr_ref, curr_aln)
                    curr_aln = i
                    _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
            else:  # normal substitution
                if r == dna.N or q == dna.N:
                    if retain_n:
                        curr_ref = a2r(ref, i, curr_ref, curr_aln)
                        curr_aln = i
                        _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
                else:
                    curr_ref = a2r(ref, i, curr_ref, curr_aln)
                    curr_aln = i
                    if i < n - 1:
                        nr, nq = int(ref.seq[i + 1]), int(alt.seq[i + 1])
                        if nr != dna.GAP and nq != dna.GAP:
                            _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
                        elif substitutions_only:
                            _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
                    else:
                        _emit(out, chr_, curr_ref + 1, _b2s(r), _b2s(q))
            insertion = False
        elif insertion:
            past_start = True
            insertion = False
            if not substitutions_only:
                curr_ref = a2r(ref, ins_pos, curr_ref, curr_aln)
                curr_aln = ins_pos
                _emit(out, chr_, curr_ref + 1, _b2s(ref.seq[ins_pos]),
                      _b2s(alt.seq[ins_pos:i]))
        elif deletion:
            past_start = True
            deletion = False
            if not substitutions_only and del_pos >= 0:
                curr_ref = a2r(ref, del_pos, curr_ref, curr_aln)
                curr_aln = del_pos
                _emit(out, chr_, curr_ref + 1, _b2s(ref.seq[del_pos:i]),
                      _b2s(alt.seq[del_pos]))


def multi_fa_to_vcf(in_file: str, chr_: str, out_file: str, *,
                    substitutions_only: bool = False, retain_n: bool = False,
                    second_query_name: str = "") -> None:
    f = fastaio.read(in_file)
    with fileio.easy_create(out_file) as out:
        vcfio.new_write_header(out, vcfio.new_header())
        if second_query_name:
            m = fastaio.to_map(f)
            if second_query_name not in m:
                raise SystemExit("Error: second query name is specified, "
                                 "but not found in the input multiFa file.")
            pair = [f[0], fastaio.Fasta(second_query_name,
                                        m[second_query_name])]
            pairwise_fa_to_vcf(pair, chr_, out, substitutions_only, retain_n)
        elif len(f) == 2:
            pairwise_fa_to_vcf(f, chr_, out, substitutions_only, retain_n)
        elif len(f) == 3:
            three_way_fa_to_vcf(f, chr_, out)
        else:
            raise SystemExit("Error: expecting 2 or 3 sequences in the "
                             "input FASTA.")


def three_way_fa_to_vcf(f, chr_: str, out) -> None:
    """convert.ThreeWayFaToVcf (convert.go:203): segregating substitution
    sites with entry 0 as reference and entries 1 and 2 as the two
    alleles; genotypes 1/0, 0/1, 1/1 or 1/2. Columns with a gap are
    skipped."""
    if len(f) != 3:
        raise SystemExit("ThreeWayFaToVcf expects a fasta input with "
                         "three entries.")
    s0 = np.asarray(f[0].seq)
    s1 = np.asarray(f[1].seq)
    s2 = np.asarray(f[2].seq)
    curr_ref_pos, curr_aln_pos = 0, 0
    for i in range(len(s0)):
        if s0[i] == dna.GAP or s1[i] == dna.GAP or s2[i] == dna.GAP:
            continue
        b0, b1, b2 = int(s0[i]), int(s1[i]), int(s2[i])
        if b0 != b1 or b0 != b2:
            curr_ref_pos = fastaio.aln_pos_to_ref_pos_counter(
                f[0], i, curr_ref_pos, curr_aln_pos)
            curr_aln_pos = i
            if b0 != b1 and b0 == b2:
                alt = [dna.to_string(s1[i:i + 1])]
                alleles = [1, 0]
            elif b0 == b1 and b0 != b2:
                alt = [dna.to_string(s2[i:i + 1])]
                alleles = [0, 1]
            elif b1 == b2:
                alt = [dna.to_string(s1[i:i + 1])]
                alleles = [1, 1]
            else:
                alt = [dna.to_string(s1[i:i + 1]),
                       dna.to_string(s2[i:i + 1])]
                alleles = [1, 2]
            vcfio.write_vcf(out, vcfio.Vcf(
                chrom=chr_, pos=curr_ref_pos + 1, id=".",
                ref=dna.to_string(s0[i:i + 1]), alt=alt, qual=100.0,
                filter="PASS", info=".", format=["GT"],
                samples=[vcfio.Sample(alleles=alleles,
                                      phase=[False, False],
                                      format_data=[""])]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaToVcf")
    p.add_argument("input")
    p.add_argument("chrom")
    p.add_argument("output")
    p.add_argument("-substitutionsOnly", action="store_true")
    p.add_argument("-retainN", action="store_true")
    p.add_argument("-secondQueryName", default="")
    a = p.parse_args(argv)
    multi_fa_to_vcf(a.input, a.chrom, a.output,
                    substitutions_only=a.substitutionsOnly,
                    retain_n=a.retainN,
                    second_query_name=a.secondQueryName)


if __name__ == "__main__":
    main()
