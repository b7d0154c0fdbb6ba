"""mafFilter, mafToBed, mafToMultiFa and mafIndels: a copy of
``gonomics_tpu/cli/maf_tools.py`` (139 lines, whole), gonomics'
``cmd/{mafFilter,mafToBed,mafToMultiFa,mafIndels}``, their flags,
defaults and error texts unchanged. The umbrella reaches each through
its ``module:function`` target (``main_filter``, ``main_to_bed``,
``main_to_multi_fa``, ``main_indels``).

    gonomics-torch mafFilter in.maf out.maf [-threshold 0]
    gonomics-torch mafToBed in.maf out.bed referenceSpecies
    gonomics-torch mafToMultiFa in.maf ref.fa species.list out.fa
        [-noMask]
    gonomics-torch mafIndels in.maf speciesIns speciesDel outIns.bed
        outDel.bed [-eiThreshold 0.1]

mafToBed writes a block's last ``s`` line of the reference species,
named with every assembly of the block joined by ``;``, score
``int(score)``, 5 fields. mafIndels exits on a wrong speciesIns only in
blocks of two or more species, and tags an ``e`` line ``eI`` where its
size is under eiThreshold times the first species' size. ``-noMask``
upper-cases the alignment.
"""

from __future__ import annotations

import argparse

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io import maf as mafio


def maf_filter(in_file: str, out_file: str, threshold: float = 0) -> None:
    """cmd/mafFilter/mafFilter.go:14."""
    mafio.write(out_file,
                [m for m in mafio.read(in_file) if m.score >= threshold])


def maf_to_bed(maf_file: str, out_bed: str, reference: str) -> None:
    """cmd/mafToBed/mafToBed.go:15: ref-species spans, score = maf
    score, name = semicolon-joined assemblies."""
    out: list[bedio.Bed] = []
    for m in mafio.read(maf_file):
        assemblies = []
        current = None
        for sp in m.species:
            assembly, chrom = mafio.src_to_assembly_and_chrom(sp.src)
            assemblies.append(assembly)
            if assembly == reference and sp.s_line is not None:
                current = bedio.Bed(
                    chrom=chrom, chrom_start=sp.s_line.start,
                    chrom_end=sp.s_line.start + sp.s_line.size,
                    name="blank", score=int(m.score),
                    fields_initialized=5)
        if any(a == reference for a in assemblies) and current is not None:
            current.name = ";".join(assemblies)
            out.append(current)
    bedio.write(out_bed, out)


def maf_to_multi_fa(in_maf: str, in_fa: str, species_list: str,
                    out_fa: str, no_mask: bool = False) -> None:
    """cmd/mafToMultiFa/mafToMultiFa.go:16."""
    blocks = mafio.read(in_maf)
    ref = fastaio.read(in_fa)
    if len(ref) != 1:
        raise SystemExit("Error: expecting input fasta to be a single "
                         f"record, but file has {len(ref)} records")
    species = list(fileio.read(species_list))
    aln = mafio.to_fasta(blocks, ref[0], species)
    if no_mask:
        for rec in aln:
            rec.seq = dna.to_upper(rec.seq)
    fastaio.write(out_fa, aln)


def maf_indels(in_maf: str, species_ins: str, species_del: str,
               threshold: float, out_ins_bed: str,
               out_del_bed: str) -> None:
    """cmd/mafIndels/mafIndels.go:17: eC/eI deletion evidence in
    pairwise mafs."""
    blocks = mafio.read(in_maf)
    with fileio.easy_create(out_ins_bed) as out_ins, \
            fileio.easy_create(out_del_bed) as out_del:
        for m in blocks:
            for sp in m.species[1:]:
                assembly_del, chrom_del = mafio.src_to_assembly_and_chrom(
                    sp.src)
                assembly_ins, chrom_ins = mafio.src_to_assembly_and_chrom(
                    m.species[0].src)
                if assembly_ins != species_ins:
                    raise SystemExit(
                        "species_ins was incorrect. Please check you have "
                        "a pairwise maf file, and entered species_ins and "
                        "species_del correctly")
                if (sp.e_line is None or assembly_del != species_del
                        or m.species[0].s_line is None):
                    continue
                e, s0 = sp.e_line, m.species[0].s_line
                if e.status == "C":
                    tag = "eC"
                elif (e.status == "I"
                      and float(e.size) < threshold * float(s0.size)):
                    tag = "eI"
                else:
                    continue
                bedio.write_to_handle(out_ins, bedio.Bed(
                    chrom=chrom_ins, chrom_start=s0.start,
                    chrom_end=s0.start + s0.size, name=f"ins_{tag}",
                    score=int(m.score), fields_initialized=5))
                bedio.write_to_handle(out_del, bedio.Bed(
                    chrom=chrom_del, chrom_start=e.start,
                    chrom_end=e.start + e.size, name=f"del_{tag}",
                    score=int(m.score), fields_initialized=5))


def main_filter(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mafFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-threshold", type=float, default=0)
    a = p.parse_args(argv)
    maf_filter(a.input, a.output, a.threshold)


def main_to_bed(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mafToBed")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("reference")
    a = p.parse_args(argv)
    maf_to_bed(a.input, a.output, a.reference)


def main_to_multi_fa(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mafToMultiFa")
    p.add_argument("input")
    p.add_argument("reference")
    p.add_argument("speciesList")
    p.add_argument("output")
    p.add_argument("-noMask", action="store_true")
    a = p.parse_args(argv)
    maf_to_multi_fa(a.input, a.reference, a.speciesList, a.output,
                    a.noMask)


def main_indels(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mafIndels")
    p.add_argument("input")
    p.add_argument("speciesIns")
    p.add_argument("speciesDel")
    p.add_argument("outIns")
    p.add_argument("outDel")
    p.add_argument("-eiThreshold", type=float, default=0.1)
    a = p.parse_args(argv)
    maf_indels(a.input, a.speciesIns, a.speciesDel, a.eiThreshold,
               a.outIns, a.outDel)
