"""vcfFormat: a VCF rewritten, a copy of
``gonomics_tpu/cli/vcf_format.py`` (183 lines), its flags unchanged.

    gonomics-torch vcfFormat in.vcf out.vcf [-ensemblToUCSC |
        -UCSCToEnsembl] [-clearInfo] [-fix -ref ref.fa] [-csv]

The chromosome names of 1-22, X and Y go between Ensembl's and UCSC's
spellings (``ensembl_to_ucsc``, ``ucsc_to_ensembl``, which bedFormat
imports); ``-clearInfo`` writes INFO as "."; ``-fix`` anchors a "-"
allele on the base before it (``fix_vcf``: only alt[0] is looked at);
``-csv`` writes a table, a column a field of each INFO key and of each
FORMAT key of each sample, floats in Go's %v.
"""

from __future__ import annotations

import argparse

from .. import dna as dnalib
from .. import fileio
from ..io import fasta as fastaio
from ..io import vcf as vcfio
from ..io.wig import go_fmt_g

_ENS_TO_UCSC = {str(i): f"chr{i}" for i in list(range(1, 23)) + ["X", "Y"]}
_UCSC_TO_ENS = {v: k for k, v in _ENS_TO_UCSC.items()}


def ensembl_to_ucsc(chrom: str) -> str:
    """convert.EnsemblToUCSC (ensemblUcscChrom.go:8); unknown passthrough."""
    return _ENS_TO_UCSC.get(chrom, chrom)


def ucsc_to_ensembl(chrom: str) -> str:
    return _UCSC_TO_ENS.get(chrom, chrom)


def fix_vcf(v: vcfio.Vcf, ref: dict) -> vcfio.Vcf:
    """vcf.FixVcf / fixDash (fix.go:23). The reference returns inside the
    alt loop, so only Alt[0] is inspected and the Ref=='-' branch is
    reachable only for records with no alt alleles — preserved here."""
    if v.alt:
        if v.alt[0] == "-":
            prev = dnalib.to_string(ref[v.chrom][v.pos - 2:v.pos - 1])
            v.pos -= 1
            v.ref = prev + v.ref
            v.alt[0] = prev
        return v
    if v.ref == "-":
        prev = dnalib.to_string(ref[v.chrom][v.pos - 2:v.pos - 1])
        v.pos -= 1
        v.ref = prev
        v.alt = [prev + a for a in v.alt]
    return v


def _number_of_fields(max_alts: int, k: vcfio.Key) -> int:
    """cmd/vcfFormat/table.go:113 numberOfFields."""
    if k.number == "A":
        return max_alts
    if k.number == "R":
        return max_alts + 1
    if k.number in ("G", "."):
        return 1
    return int(k.number)


def _write_table_header(out, meta: vcfio.HeaderMeta, max_alts: int):
    parts = ["Chromosome,Position,ID,Reference"]
    if max_alts == 1:
        parts.append(",Alternate")
    else:
        for i in range(max_alts):
            parts.append(f",Alternate_{i}")
    parts.append(",Quality,Filter")
    for key, val in meta.info.items():
        n = _number_of_fields(max_alts, val)
        if n == 1:
            parts.append("," + key)
        else:
            for i in range(n):
                parts.append(f",{key}_{i}")
    for fmt in meta.format.values():
        for sample in meta.samples:
            n = _number_of_fields(max_alts, fmt)
            if n == 1:
                parts.append(f",{fmt.id}_{sample}")
            else:
                for i in range(n):
                    parts.append(f",{fmt.id}_{sample}_{i}")
    out.write("".join(parts) + "\n")


def _write_data(parts: list, data, key: vcfio.Key, n_fields: int,
                repeats: int) -> None:
    """table.go:137 writeData: per-sample values with intra-sample comma
    padding, then pad to n_fields*repeats columns total."""
    written = 0
    if data is not None and not isinstance(data, bool):
        for sample_vals in data:
            inner = 0
            for x in sample_vals:
                if key.data_type == vcfio.INTEGER:
                    parts.append(f",{x}")
                elif key.data_type == vcfio.FLOAT:
                    parts.append("," + go_fmt_g(x))
                else:
                    parts.append(f",{x}")
                written += 1
                inner += 1
            for _ in range(inner, n_fields):
                parts.append(",")
                written += 1
    elif key.data_type == vcfio.FLAG:
        parts.append(",TRUE" if data else ",FALSE")
        written += 1
        for _ in range(1, n_fields):
            parts.append(",")
            written += 1
    for _ in range(written, n_fields * repeats):
        parts.append(",")


def _write_as_table(out, v: vcfio.Vcf, meta: vcfio.HeaderMeta,
                    max_alts: int) -> None:
    parts = [f"{v.chrom},{v.pos},{v.id},{v.ref},{','.join(v.alt)}"]
    for _ in range(len(v.alt), max_alts):
        parts.append(",")
    parts.append("," + go_fmt_g(v.qual) + "," + v.filter)
    info = vcfio.parse_info(v, meta)
    for key, tag in meta.info.items():
        data = info.get(key) if (tag.data_type != vcfio.FLAG) \
            else info.get(key, False)
        _write_data(parts, data, tag, _number_of_fields(max_alts, tag), 1)
    fmt = vcfio.parse_format(v, meta)
    for key, tag in meta.format.items():
        _write_data(parts, fmt.get(key), tag,
                    _number_of_fields(max_alts, tag), len(v.samples))
    out.write("".join(parts) + "\n")


def vcf_format(infile: str, outfile: str, *, ensembl_to_ucsc_flag=False,
               ucsc_to_ensembl_flag=False, fix=False, ref="",
               clear_info=False, table_output=False) -> None:
    if ensembl_to_ucsc_flag and ucsc_to_ensembl_flag:
        raise SystemExit("Both conversions are incompatible.")
    records, header = vcfio.read(infile)
    meta = vcfio.parse_header_meta(header)
    max_alts = max((len(v.alt) for v in records), default=0) \
        if table_output else 0
    ref_map = {}
    if fix:
        ref_map = {f.name: f.seq for f in fastaio.read(ref)}
    out = fileio.easy_create(outfile)
    if table_output:
        if not header.text:
            raise SystemExit("no vcf header found")
        _write_table_header(out, meta, max_alts)
    else:
        vcfio.new_write_header(out, header)
    for v in records:
        if clear_info:
            v.info = "."
        if fix:
            v = fix_vcf(v, ref_map)
        if ensembl_to_ucsc_flag:
            v.chrom = ensembl_to_ucsc(v.chrom)
        if ucsc_to_ensembl_flag:
            v.chrom = ucsc_to_ensembl(v.chrom)
        if table_output:
            _write_as_table(out, v, meta, max_alts)
        else:
            vcfio.write_vcf(out, v)
    out.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfFormat")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-ensemblToUCSC", action="store_true")
    p.add_argument("-UCSCToEnsembl", action="store_true")
    p.add_argument("-clearInfo", action="store_true")
    p.add_argument("-fix", action="store_true")
    p.add_argument("-ref", default="")
    p.add_argument("-csv", action="store_true")
    a = p.parse_args(argv)
    vcf_format(a.input, a.output, ensembl_to_ucsc_flag=a.ensemblToUCSC,
               ucsc_to_ensembl_flag=a.UCSCToEnsembl, fix=a.fix, ref=a.ref,
               clear_info=a.clearInfo, table_output=a.csv)


if __name__ == "__main__":
    main()
