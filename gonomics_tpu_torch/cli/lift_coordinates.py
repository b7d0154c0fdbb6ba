"""liftCoordinates: bed or VCF records lifted from one assembly to
another through a chain file; a copy of
``gonomics_tpu/cli/lift_coordinates.py`` (205 lines).

    gonomics-torch liftCoordinates in.chain in.bed|in.vcf out unmapped
        [-minMatch 0.95] [-faFile query.fa [-swapAB]]

A record is lifted by the one chain whose target span overlaps it,
where both of ``match_proportion``'s shares reach ``-minMatch``; it goes
to the unmapped file, after a line that says why, where no chain or
more than one chain covers it. A VCF record's span is [pos - 1, pos) for
a one-base REF, else [pos, pos + len(REF) - 1), so the probe of a
multi-base REF starts at pos. With ``-faFile`` (VCF only; the Seeker
reads ``<fa>.fai``) a lifted SNP whose REF the query lacks but whose ALT
it carries is written with its alleles and genotypes inverted, and with
``-swapAB`` the first character of its ``ALLELE_A=`` and ``ALLELE_B=``
values swapped; indels and multiallelic records go to the unmapped file.
"""

from __future__ import annotations

import argparse

from .. import dna, fileio
from ..interval import IntervalIndex
from ..io import bed as bedio
from ..io import formats
from ..io import vcf as vcfio
from ..io.fai import Seeker


class _ChainWrap:
    """A chain as its target span, for IntervalIndex."""

    def __init__(self, c: formats.Chain):
        self.chain = c
        self.chrom = c.t_name
        self.chrom_start = c.t_start
        self.chrom_end = c.t_end


def match_proportion(c: formats.Chain, start: int, end: int):
    """lift.MatchProportion (lift.go:104): (matched / (matched + target
    gap bases), matched / (matched + query gap bases)) over [start, end)
    of the target; (0, 0) where no base matches."""
    def overlap(s1, e1):
        return max(0, min(e1, end) - max(s1, start))

    match = d_t = d_q = 0
    pos = c.t_start
    for a in c.alignment:
        match += overlap(pos, pos + a.size)
        pos += a.size
        ot = overlap(pos, pos + a.t_bases)
        d_t += ot
        if ot > 0:
            d_q += a.q_bases
        pos += a.t_bases
    if match == 0:
        return 0.0, 0.0
    return match / (match + d_t), match / (match + d_q)


def lift_with_chain(c: formats.Chain, start: int, end: int):
    """lift.LiftCoordinatesWithChain (lift.go:74): (query name, start,
    end) of target [start, end)."""
    new_start, _ = formats.t_pos_to_q_pos(c, start)
    new_end, _ = formats.t_pos_to_q_pos(c, end - 1)
    new_end += 1
    if not c.q_strand:
        new_start, new_end = new_end, new_start
        new_start += 1
        new_end += 1
    return c.q_name, new_start, new_end


def _query_seq(seeker: Seeker, chrom: str, idx: int, query: str) -> bool:
    fetch = seeker.seek_by_name(chrom, idx, idx + len(query))
    want = dna.to_upper(dna.from_string(query))
    got = dna.to_upper(fetch)
    return len(want) == len(got) and bool((want == got).all())


def _swap_info_alleles(v: vcfio.Vcf) -> None:
    """The first characters of the ALLELE_A= and ALLELE_B= values
    swapped, where INFO holds both."""
    info = v.info
    ia = info.find("ALLELE_A=")
    ib = info.find("ALLELE_B=")
    if ia == -1 or ib == -1:
        return
    ia += len("ALLELE_A=")
    ib += len("ALLELE_B=")
    chars = list(info)
    chars[ia], chars[ib] = chars[ib], chars[ia]
    v.info = "".join(chars)


def _invert_vcf(v: vcfio.Vcf) -> None:
    v.ref, v.alt[0] = v.alt[0], v.ref
    for s in v.samples:
        if s.alleles:
            s.alleles = [1 if a == 0 else 0 if a == 1 else a
                         for a in s.alleles]


def lift_coordinates(chain_file: str, in_file: str, out_file: str,
                     unmapped_file: str, *, min_match: float = 0.95,
                     fa_file: str = "", swap_ab: bool = False) -> None:
    if not 0 <= min_match <= 1:
        raise SystemExit("minMatch must be between 0 and 1")
    chains, _ = formats.read_chain(chain_file)
    index = IntervalIndex([_ChainWrap(c) for c in chains])

    base = in_file[:-3] if in_file.endswith(".gz") else in_file
    is_vcf = base.endswith(".vcf")
    seeker = Seeker(fa_file) if fa_file else None
    if fa_file and not is_vcf:
        raise SystemExit("Fasta file is provided but lift file is not VCF")

    out = fileio.easy_create(out_file)
    un = fileio.easy_create(unmapped_file)

    if is_vcf:
        records, header = vcfio.read(in_file)
        vcfio.new_write_header(out, vcfio.Header(text=header.text))
        items = records
    else:
        items = bedio.read(in_file)

    for rec in items:
        if is_vcf:
            start = rec.pos - 1 if len(rec.ref) == 1 else rec.pos
            end = rec.pos if len(rec.ref) == 1 else rec.pos + len(rec.ref) - 1
            chrom = rec.chrom
            write_rec = lambda f, r=rec: f.write(r.to_string() + "\n")
        else:
            chrom, start, end = rec.chrom, rec.chrom_start, rec.chrom_end
            write_rec = lambda f, r=rec: bedio.write_to_handle(f, r)
        overlap = index.query(bedio.Bed(chrom, start, end), "any")
        if len(overlap) > 1:
            un.write("Record below maps to multiple chains:\n")
            write_rec(un)
            continue
        if not overlap:
            un.write("Record below has no ortholog in new assembly:\n")
            write_rec(un)
            continue
        c = overlap[0].chain
        a, b = match_proportion(c, start, end)
        if a < min_match or b < min_match:
            un.write(f"Record below fails minMatch with a proportion of "
                     f"{min(a, b):f}. Here's the corresponding chain: "
                     f"{c.score}.\n")
            write_rec(un)
            continue
        new_chrom, new_start, new_end = lift_with_chain(c, start, end)
        if not is_vcf:
            rec.chrom = new_chrom
            rec.chrom_start = new_start
            rec.chrom_end = new_end
            write_rec(out)
            continue
        rec.chrom = new_chrom
        rec.pos = new_start + 1
        if seeker is None:
            write_rec(out)
        elif len(rec.ref) > 1 or len(rec.alt[0]) > 1:
            un.write("The following record did not lift as VCF lift is not "
                     "currently supported for INDEL records.\n")
            write_rec(un)
        elif len(rec.alt) > 1:
            un.write("The following record did not lift as VCF lift is not "
                     "currently supported for multiallelic sites.\n")
            write_rec(un)
        elif _query_seq(seeker, rec.chrom, rec.pos - 1, rec.ref):
            write_rec(out)
        elif _query_seq(seeker, rec.chrom, rec.pos - 1, rec.alt[0]):
            un.write("Record below was lifted, but the ref and alt alleles "
                     "are inverted:\n")
            write_rec(un)
            _invert_vcf(rec)
            if swap_ab:
                _swap_info_alleles(rec)
            write_rec(out)
        else:
            un.write("For the following record, neither the Ref nor the "
                     "Alt allele matched the bases in the corresponding "
                     "destination fasta location.\n")
            write_rec(un)
    out.close()
    un.close()
    if seeker is not None:
        seeker.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="liftCoordinates")
    p.add_argument("chain")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("unmapped")
    p.add_argument("-minMatch", type=float, default=0.95)
    p.add_argument("-faFile", default="")
    p.add_argument("-swapAB", action="store_true")
    a = p.parse_args(argv)
    lift_coordinates(a.chain, a.input, a.output, a.unmapped,
                     min_match=a.minMatch, fa_file=a.faFile,
                     swap_ab=a.swapAB)


if __name__ == "__main__":
    main()
