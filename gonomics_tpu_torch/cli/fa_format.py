"""faFormat: reformat FASTA records, a copy of
``gonomics_tpu/cli/fa_format.py`` (182 lines), its flags and defaults
unchanged.

    gonomics-torch faFormat in.fa out.fa [-lineLength 50] [-toUpper]
        [-toLower regions.bed [-ignoreExtraRegions]] [-revComp]
        [-noGaps] [-noGapBed out.bed] [-index] [-maskInvalid]
        [-fastaNamesFile names.txt] [-trimName] [-rename old,new]
        [-multiFaNoGapBed out.bed -querySeqName q -chromName c]

With ``-fastaNamesFile`` only the named records are edited, but every
record is written (fa_format.py:117-145).
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fai, fasta as fastaio


def ungapped_regions_from_fa(rec: fastaio.Fasta) -> list[bedio.Bed]:
    """bed.UngappedRegionsFromFa: the maximal runs of A, C, G and T (either
    case) of a record, as 4-field beds named chrom_start_end."""
    ok = dna.define_base_mask(np.asarray(rec.seq))
    out: list[bedio.Bed] = []
    if not len(ok):
        return out
    edges = np.flatnonzero(np.diff(ok.astype(np.int8)))
    starts = list((edges + 1)[~ok[edges]]) if len(edges) else []
    if ok[0]:
        starts = [0] + starts
    ends = list((edges + 1)[ok[edges]]) if len(edges) else []
    if ok[-1]:
        ends = ends + [len(ok)]
    for s, e in zip(starts, ends):
        out.append(bedio.Bed(rec.name, int(s), int(e),
                             name=f"{rec.name}_{int(s)}_{int(e)}",
                             fields_initialized=4))
    return out


def multi_fa_ungapped_regions(records, chrom_name: str,
                              seq_name: str) -> list[bedio.Bed]:
    """bed.MultiFaUngappedRegions: the ungapped regions of seq_name in
    the coordinates of the first record."""
    idxs = [i for i, r in enumerate(records) if r.name == seq_name]
    if len(idxs) != 1:
        raise SystemExit(f"seqName {seq_name} not found exactly once")
    seq = np.asarray(records[idxs[0]].seq)
    ok = dna.define_base_mask(seq)
    out: list[bedio.Bed] = []
    in_region = False
    start_ref = 0
    last_ref, last_aln = 0, 0
    for pos in range(len(records[0].seq)):
        if ok[pos] and not in_region:
            in_region = True
            start_ref = fastaio.aln_pos_to_ref_pos_counter(
                records[0], pos, last_ref, last_aln)
            last_ref, last_aln = start_ref, pos
        elif not ok[pos] and in_region:
            end_ref = fastaio.aln_pos_to_ref_pos_counter(
                records[0], pos, last_ref, last_aln)
            last_ref, last_aln = end_ref, pos
            out.append(bedio.Bed(chrom_name, start_ref, end_ref))
            in_region = False
    if in_region:
        end_ref = fastaio.aln_pos_to_ref_pos_counter(
            records[0], len(records[0].seq), last_ref, last_aln)
        out.append(bedio.Bed(chrom_name, start_ref, end_ref))
    return out


def bed_to_lower(records, regions: list[bedio.Bed],
                 ignore_extra: bool) -> None:
    by_name = {r.name: r for r in records}
    for b in regions:
        if b.chrom not in by_name:
            if ignore_extra:
                continue
            raise SystemExit(f"bed region chrom {b.chrom} not in fasta")
        rec = by_name[b.chrom]
        rec.seq[b.chrom_start:b.chrom_end] = dna.to_lower(
            rec.seq[b.chrom_start:b.chrom_end])


def fa_format(in_file: str, out_file: str, *, line_length: int = 50,
              names_file: str = "", trim_name: bool = False,
              to_upper: bool = False, to_lower: str = "",
              rev_comp: bool = False, no_gaps: bool = False,
              no_gap_bed: str = "", index: bool = False,
              mask_invalid: bool = False, multi_fa_no_gap_bed: str = "",
              query_seq_name: str = "", chrom_name: str = "",
              rename: str = "", ignore_extra_regions: bool = False) -> None:
    records = (fastaio.read_forced(in_file) if mask_invalid
               else fastaio.read(in_file))

    if no_gap_bed:
        beds = []
        for r in records:
            beds.extend(ungapped_regions_from_fa(r))
        bedio.write(no_gap_bed, beds)

    if multi_fa_no_gap_bed:
        if not query_seq_name or not chrom_name:
            raise SystemExit("multiFaNoGapBed requires querySeqName and "
                             "chromName")
        bedio.write(multi_fa_no_gap_bed,
                    multi_fa_ungapped_regions(records, chrom_name,
                                              query_seq_name))

    if no_gaps:
        for r in records:
            r.seq = r.seq[np.asarray(r.seq) != dna.GAP]

    names = set(fileio.read(names_file)) if names_file else None
    rename_pair = rename.split(",") if rename else None
    if rename_pair and len(rename_pair) != 2:
        raise SystemExit("expected two comma-delimited fields in -rename")

    if to_lower:
        bed_to_lower(records, bedio.read(to_lower), ignore_extra_regions)

    for r in records:
        if names is not None and r.name not in names:
            continue
        if trim_name:
            r.name = r.name.split(" ")[0]
        if to_upper:
            r.seq = dna.to_upper(r.seq).astype(np.int8)
        if rev_comp:
            r.seq = dna.reverse_complement(r.seq).astype(np.int8)
            r.name += "_RevComp"
        if rename_pair and r.name == rename_pair[0]:
            r.name = rename_pair[1]
    fastaio.write(out_file, records, line_length)

    if index:
        fai.write_index(fai.create_index(out_file), out_file + ".fai")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faFormat")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-lineLength", type=int, default=50)
    p.add_argument("-fastaNamesFile", default="")
    p.add_argument("-trimName", action="store_true")
    p.add_argument("-toUpper", action="store_true")
    p.add_argument("-toLower", default="")
    p.add_argument("-revComp", action="store_true")
    p.add_argument("-noGaps", action="store_true")
    p.add_argument("-noGapBed", default="")
    p.add_argument("-index", action="store_true")
    p.add_argument("-maskInvalid", action="store_true")
    p.add_argument("-multiFaNoGapBed", default="")
    p.add_argument("-querySeqName", default="")
    p.add_argument("-chromName", default="")
    p.add_argument("-rename", default="")
    p.add_argument("-ignoreExtraRegions", action="store_true")
    a = p.parse_args(argv)
    fa_format(a.input, a.output, line_length=a.lineLength,
              names_file=a.fastaNamesFile, trim_name=a.trimName,
              to_upper=a.toUpper, to_lower=a.toLower, rev_comp=a.revComp,
              no_gaps=a.noGaps, no_gap_bed=a.noGapBed, index=a.index,
              mask_invalid=a.maskInvalid,
              multi_fa_no_gap_bed=a.multiFaNoGapBed,
              query_seq_name=a.querySeqName, chrom_name=a.chromName,
              rename=a.rename, ignore_extra_regions=a.ignoreExtraRegions)


if __name__ == "__main__":
    main()
