"""bedFormat: bed records reformatted, a copy of
``gonomics_tpu/cli/bed_format.py`` (144 lines), its flags and defaults
unchanged.

    gonomics-torch bedFormat in.bed out.bed [-coordName]
        [-ToMidpoint | -ToTss] [-evenPadLength n] [-upstreamPadLength n]
        [-downstreamPadLength n] [-chromSizeFile sizes]
        [-ensemblToUCSC | -UCSCToEnsembl] [-scaleNameFloat f]
        [-fdrAnnotation [-rawPValueAnnotationField i]]

The steps run in that order on each record; padding is clipped to 0
and to the chromosome's size; ``-scaleNameFloat`` writes the scaled
name with ``:.8g``; ``-fdrAnnotation`` appends a Benjamini-Hochberg
adjusted -log10 p (``go_fmt_e``) computed from the raw -log10 p in the
given annotation field, ranks taken from the largest raw value down.
"""

from __future__ import annotations

import argparse
import math

from .. import fileio
from ..io import bed as bedio
from ..io import chrom_info
from .fa_find_fast import go_fmt_e
from .vcf_format import ensembl_to_ucsc, ucsc_to_ensembl


def bed_format(in_file: str, out_file: str, *, coord_name: bool = False,
               ucsc_to_ensembl_flag: bool = False,
               ensembl_to_ucsc_flag: bool = False,
               scale_name_float: float = 1.0, even_pad: int = 0,
               upstream_pad: int = 0, downstream_pad: int = 0,
               chrom_size_file: str = "", to_midpoint: bool = False,
               to_tss: bool = False, fdr_annotation: bool = False,
               raw_p_field: int = 0) -> None:
    if ensembl_to_ucsc_flag and ucsc_to_ensembl_flag:
        raise SystemExit("Both conversions (UCSCToEnsembl and "
                         "EnsemblToUCSC) are incompatible.")
    if not chrom_size_file and (even_pad > 0 or upstream_pad > 0
                                or downstream_pad > 0):
        raise SystemExit("Must specify a chromFile to use a padLength "
                         "option.")
    if to_tss and to_midpoint:
        raise SystemExit("Cannot trim bed elements to midpoint AND to Tss.")
    sizes = (chrom_info.read_to_map(chrom_size_file)
             if chrom_size_file else {})

    processed: list[bedio.Bed] = []
    fdr_counts: dict[float, int] = {}
    for v in bedio.read(in_file):
        if coord_name:
            if v.fields_initialized == 3:
                v.fields_initialized = 4
            v.name = f"{v.chrom}.{v.chrom_start}.{v.chrom_end}"
        if to_midpoint:
            v = bedio.to_midpoint(v)
        if to_tss:
            v = bedio.to_tss(v)
        if even_pad > 0:
            if v.chrom not in sizes:
                raise SystemExit("Chrom for current bed entry not found in "
                                 f"chromSizes file. BedChrom: {v.chrom}.")
            v.chrom_start = max(v.chrom_start - even_pad, 0)
            v.chrom_end = min(v.chrom_end + even_pad, sizes[v.chrom].size)
        if upstream_pad > 0:
            if v.chrom not in sizes:
                raise SystemExit("Chrom for current bed entry not found in "
                                 f"chromSizes file. BedChrom: {v.chrom}.")
            if v.strand == bedio.POSITIVE:
                v.chrom_start = max(v.chrom_start - upstream_pad, 0)
            elif v.strand == bedio.NEGATIVE:
                v.chrom_end = min(v.chrom_end + upstream_pad,
                                  sizes[v.chrom].size)
            else:
                raise SystemExit("Bed entries must have annotated strand "
                                 "information to perform upstream padding.")
        if downstream_pad > 0:
            if v.chrom not in sizes:
                raise SystemExit("Chrom for current bed entry not found in "
                                 f"chromSizes file. BedChrom: {v.chrom}.")
            if v.strand == bedio.POSITIVE:
                v.chrom_end = min(v.chrom_end + downstream_pad,
                                  sizes[v.chrom].size)
            elif v.strand == bedio.NEGATIVE:
                v.chrom_start = max(v.chrom_start - downstream_pad, 0)
            else:
                raise SystemExit("Bed entries must have annotated strand "
                                 "information to perform downstream "
                                 "padding.")
        if ensembl_to_ucsc_flag:
            v.chrom = ensembl_to_ucsc(v.chrom)
        if ucsc_to_ensembl_flag:
            v.chrom = ucsc_to_ensembl(v.chrom)
        if scale_name_float != 1:
            v.name = f"{scale_name_float * float(v.name):.8g}"
        if fdr_annotation:
            if raw_p_field >= len(v.annotation):
                raise SystemExit(
                    f"Error: rawPValueAnnotationField, {raw_p_field}, "
                    "exceeds the length of the annotation slice in bed "
                    f"entry: {len(v.annotation)}.")
            raw = float(v.annotation[raw_p_field])
            fdr_counts[raw] = fdr_counts.get(raw, 0) + 1
        processed.append(v)

    with fileio.easy_create(out_file) as out:
        if not fdr_annotation:
            for v in processed:
                bedio.write_to_handle(out, v)
            return
        # FDR (Benjamini-Hochberg in -log10 space, bedFormat.go:167-188):
        # ranks accumulate from the largest raw (-log10) p downward.
        total = len(processed)
        adj: dict[float, float] = {}
        rank = 0
        for raw in sorted(fdr_counts, reverse=True):
            rank += fdr_counts[raw]
            # Go math.Max(-0, 0) returns +0; Python max() keeps the first
            # arg on ties, so order matters for the -0.0 case
            adj[raw] = max(0.0, raw - math.log10(total / rank))
        for v in processed:
            raw = float(v.annotation[raw_p_field])
            v.annotation = v.annotation + [go_fmt_e(adj[raw])]
            bedio.write_to_handle(out, v)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedFormat")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-coordName", action="store_true")
    p.add_argument("-evenPadLength", type=int, default=0)
    p.add_argument("-upstreamPadLength", type=int, default=0)
    p.add_argument("-downstreamPadLength", type=int, default=0)
    p.add_argument("-ensemblToUCSC", action="store_true")
    p.add_argument("-UCSCToEnsembl", action="store_true")
    p.add_argument("-scaleNameFloat", type=float, default=1)
    p.add_argument("-chromSizeFile", default="")
    p.add_argument("-ToMidpoint", action="store_true")
    p.add_argument("-ToTss", action="store_true")
    p.add_argument("-fdrAnnotation", action="store_true")
    p.add_argument("-rawPValueAnnotationField", type=int, default=0)
    a = p.parse_args(argv)
    bed_format(a.input, a.output, coord_name=a.coordName,
               ucsc_to_ensembl_flag=a.UCSCToEnsembl,
               ensembl_to_ucsc_flag=a.ensemblToUCSC,
               scale_name_float=a.scaleNameFloat,
               even_pad=a.evenPadLength, upstream_pad=a.upstreamPadLength,
               downstream_pad=a.downstreamPadLength,
               chrom_size_file=a.chromSizeFile, to_midpoint=a.ToMidpoint,
               to_tss=a.ToTss, fdr_annotation=a.fdrAnnotation,
               raw_p_field=a.rawPValueAnnotationField)


if __name__ == "__main__":
    main()
