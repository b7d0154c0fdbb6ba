"""samToWig: read coverage of a SAM or BAM file as a fixed-step wig; a
copy of ``gonomics_tpu/cli/sam_to_wig.py`` (107 lines), its flags and
defaults unchanged.

    gonomics-torch samToWig in.sam chrom.sizes out.wig [-fragLength n]
        [-defaultValue 0] [-deletions]

Each mapped read adds one over its reference span. ``-fragLength``
extends it to a fragment from its 5' end: a ``+`` fragment is clipped at
the chrom's size and a ``-`` one at 0, and a fragment shorter than a read
exits, even for an unmapped read (the check comes first).
``-deletions`` splits a read at each D; a cigar that ends in D writes no
last piece. It exits on a chrom missing from the sizes, and on
``-fragLength`` with ``-deletions``.
"""

from __future__ import annotations

import argparse

from ..io import bed as bedio
from ..io import chrom_info
from ..io import cigar as samcigar
from ..io import sam as samio
from ..io import wig as wigio


def sam_to_bed_simple(s: samio.Sam) -> bedio.Bed | None:
    """The read's reference span, None where it is unmapped."""
    if samcigar.is_unmapped(s.cigar):
        return None
    return bedio.Bed(s.rname, s.pos - 1,
                     s.pos - 1 + samcigar.reference_length(s.cigar),
                     s.qname, fields_initialized=4)


def sam_to_bed_frag(s: samio.Sam, frag_length: int,
                    sizes) -> bedio.Bed | None:
    """The read's fragment of frag_length from its 5' end, less its
    insertions and plus its deletions."""
    if frag_length < len(s.seq):
        raise SystemExit("fragLength is shorter than the sam read length")
    if samcigar.is_unmapped(s.cigar):
        return None
    n_ins = sum(c.run_length for c in s.cigar if c.op == "I")
    n_del = sum(c.run_length for c in s.cigar if c.op == "D")
    span = frag_length - n_ins + n_del
    if samio.is_pos_strand(s):
        start = s.pos - 1
        return bedio.Bed(s.rname, start,
                         min(start + span, sizes[s.rname].size),
                         s.qname, strand="+", fields_initialized=4)
    end = s.pos - 1 + samcigar.reference_length(s.cigar)
    return bedio.Bed(s.rname, max(end - span, 0), end, s.qname,
                     strand="-", fields_initialized=4)


def sam_to_beds_with_deletions(s: samio.Sam) -> list[bedio.Bed]:
    """The read's reference span cut at each deletion."""
    if samcigar.is_unmapped(s.cigar):
        return []
    out: list[bedio.Bed] = []
    curr = s.pos - 1
    start = curr
    for i, c in enumerate(s.cigar):
        if c.op == "D":
            out.append(bedio.Bed(s.rname, start, curr, s.qname,
                                 fields_initialized=4))
            start = curr + c.run_length
            curr = start
            continue
        if samcigar.consumes_reference(c.op):
            curr += c.run_length
        if i == len(s.cigar) - 1:
            out.append(bedio.Bed(s.rname, start, curr, s.qname,
                                 fields_initialized=4))
    return out


def sam_to_wig(sam_file: str, chrom_sizes: str, out_file: str, *,
               frag_length: int = -1, default_value: float = 0.0,
               deletions: bool = False) -> None:
    ref = chrom_info.read_to_map(chrom_sizes)
    answer = wigio.make_skeleton(ref, default_value)
    _header, records = samio.read(sam_file)
    for s in records:
        if frag_length != -1:
            b = sam_to_bed_frag(s, frag_length, ref)
            beds = [b] if b else []
        elif deletions:
            beds = sam_to_beds_with_deletions(s)
        else:
            b = sam_to_bed_simple(s)
            beds = [b] if b else []
        for b in beds:
            if b.chrom not in answer:
                raise SystemExit(f"Error: chrom in bed: {b.chrom}, not "
                                 "found in reference genome.")
            answer[b.chrom].values[b.chrom_start:b.chrom_end] += 1
    wigio.write(out_file, answer)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="samToWig")
    p.add_argument("input")
    p.add_argument("chromSizes")
    p.add_argument("output")
    p.add_argument("-fragLength", type=int, default=-1)
    p.add_argument("-defaultValue", type=float, default=0)
    p.add_argument("-deletions", action="store_true")
    a = p.parse_args(argv)
    if a.fragLength != -1 and a.deletions:
        raise SystemExit("ERROR: -fragLength is not compatible with "
                         "-deletions")
    sam_to_wig(a.input, a.chromSizes, a.output, frag_length=a.fragLength,
               default_value=a.defaultValue, deletions=a.deletions)


if __name__ == "__main__":
    main()
