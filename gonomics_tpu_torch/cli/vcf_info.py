"""vcfInfo: summary counts of a VCF's variants, a copy of
``gonomics_tpu/cli/vcf_info.py`` (157 lines), its flags and defaults
unchanged.

    gonomics-torch vcfInfo -i in.vcf [-types out.txt]
        [-divergence out.txt] [-context out.txt -r ref.fa [-pad 1]
        [-includeComplements]]

``-types`` counts each (ref, alt[0]) change in the reference's report
text ("Gap To G" included); ``-divergence`` counts the sites whose
ancestor (``AA=``) is the alt; ``-context`` counts each substitution
in its 2 x pad flanking bases, read from ``-r`` through the .fai
beside it, merged with its reverse complement unless
``-includeComplements``, as sorted lines. Position 1, a flank off the
chromosome and a context whose middle base is not the ref are skipped.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from .. import dna, fileio
from ..io import fai
from ..io import vcf as vcfio
from .vcf_filter import has_ancestor, is_alt_ancestor

_BASES = "ACGT"
_ORDER = ["A", "C", "G", "T", "N", "-"]


def _types_report(counts: dict, input_file: str) -> str:
    c = counts
    return (
        f"Variant statistics on file:\t{input_file}\n\n"
        "Transitions\n"
        f"A to G:\t{c['A']['G']}\nG to A:\t{c['G']['A']}\n"
        f"C to T:\t{c['C']['T']}\nT to C:\t{c['T']['C']}\n\n"
        "Transversions\n"
        f"A to C:\t{c['A']['C']}\nC to A:\t{c['C']['A']}\n"
        f"G to T:\t{c['G']['T']}\nT to G:\t{c['T']['G']}\n"
        f"A to T:\t{c['A']['T']}\nT to A:\t{c['T']['A']}\n"
        f"C to G:\t{c['C']['G']}\nG to C:\t{c['G']['C']}\n\n"
        "Gaps Introduced\n"
        f"A to Gap:\t{c['A']['-']}\nG to Gap:\t{c['G']['-']}\n"
        f"C to Gap:\t{c['C']['-']}\nT to Gap:\t{c['T']['-']}\n"
        f"N to Gap:\t{c['N']['-']}\n\n"
        "Gaps resolved\n"
        f"Gap to A:\t{c['-']['A']}\nGap to C:\t{c['-']['C']}\n"
        f"Gap to T:\t{c['-']['T']}\nGap To G:\t{c['-']['G']}\n"
        f"Gap to N:\t{c['-']['N']}\n\n"
        "N's introduced\n"
        f"A to N:\t{c['A']['N']}\nT to N:\t{c['T']['N']}\n"
        f"G to N:\t{c['G']['N']}\nC to N:\t{c['C']['N']}\n\n"
        "N's resolved\n"
        f"N to A:\t{c['N']['A']}\nN to G:\t{c['N']['G']}\n"
        f"N to T:\t{c['N']['T']}\nN to C:\t{c['N']['C']}\n\n")


def _init_context_map(pad: int) -> dict[str, dict[str, int]]:
    m: dict[str, dict[str, int]] = {}
    flanks = ["".join(p) for p in
              itertools.product(_BASES, repeat=pad * 2)]
    for a in _BASES:
        for b in _BASES:
            if a == b:
                continue
            m[f"{a}>{b}"] = {f"{fl[:pad]}{a}{fl[pad:]}": 0
                             for fl in flanks}
    return m


def _merge_complements(m: dict[str, dict[str, int]]) -> None:
    """mergeComplements (vcfInfo.go:337)."""
    for keep, drop in (("C>A", "G>T"), ("C>G", "G>C"), ("C>T", "G>A"),
                       ("T>A", "A>T"), ("T>C", "A>G"), ("T>G", "A>C")):
        for key in m[keep]:
            rc = dna.to_string(dna.reverse_complement(
                np.array(dna.from_string(key), copy=True)))
            m[keep][key] += m[drop][rc]
        del m[drop]


def vcf_info(input_file: str, *, types: str = "", divergence: str = "",
             context: str = "", include_complements: bool = False,
             pad: int = 1, ref: str = "") -> None:
    counts = {a: {b: 0 for b in _ORDER} for a in _ORDER}
    num_div = num_not_div = 0
    m = _init_context_map(pad) if context else None
    seeker = fai.Seeker(ref) if context and pad > 0 else None

    records, _ = vcfio.read(input_file)
    for v in records:
        if v.ref in counts and v.alt and v.alt[0] in counts[v.ref]:
            counts[v.ref][v.alt[0]] += 1
        if divergence:
            if not has_ancestor(v):
                raise SystemExit("Divergence can only be evaluated for "
                                 "VCF files with annotated ancestral "
                                 "alleles.")
            if is_alt_ancestor(v):
                num_div += 1
            else:
                num_not_div += 1
        if m is not None:
            _vcf_context(v, m, seeker, pad)

    if types:
        with fileio.easy_create(types) as out:
            out.write(_types_report(counts, input_file))
    if divergence:
        with fileio.easy_create(divergence) as out:
            out.write(f"Variant statistics on file:\t{input_file}\n\n")
            out.write(f"Number of Divergent Sites:\t{num_div}\n"
                      f"Number of non-divergent sites:\t{num_not_div}\n")
    if m is not None:
        if not include_complements:
            _merge_complements(m)
        lines = sorted(f"{k1}\t{k2}\t{n}" for k1, sub in m.items()
                       for k2, n in sub.items())
        with fileio.easy_create(context) as out:
            out.write("Variant\tContext\tCount\n")
            out.write("\n".join(lines) + "\n")


def _vcf_context(v, m, seeker, pad: int) -> None:
    """vcfContext (vcfInfo.go:244)."""
    if len(v.alt) != 1 or len(v.ref) != 1 or len(v.alt[0]) != 1 \
            or v.pos == 1:
        return
    top = f"{v.ref}>{v.alt[0]}"
    if top not in m:
        return
    if pad > 0:
        try:
            seq = seeker.seek_by_name(v.chrom, (v.pos - 1) - pad,
                                      (v.pos - 1) + pad + 1)
        except (KeyError, ValueError):
            return
    else:
        seq = dna.from_string(v.ref)
    if len(seq) <= pad or int(seq[pad]) != int(dna.from_string(v.ref)[0]):
        return
    bot = dna.to_string(seq)
    if bot not in m[top]:
        return
    m[top][bot] += 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfInfo")
    p.add_argument("-i", required=True)
    p.add_argument("-types", default="")
    p.add_argument("-divergence", default="")
    p.add_argument("-context", default="")
    p.add_argument("-includeComplements", action="store_true")
    p.add_argument("-pad", type=int, default=1)
    p.add_argument("-r", default="")
    a = p.parse_args(argv)
    if not (a.types or a.divergence or a.context):
        raise SystemExit("ERROR: must use at least one of -types, "
                         "-divergence, or -context")
    vcf_info(a.i, types=a.types, divergence=a.divergence,
             context=a.context, include_complements=a.includeComplements,
             pad=a.pad, ref=a.r)


if __name__ == "__main__":
    main()
