"""gtfTools: the ``filter`` and ``toBed`` subcommands; a copy of
``gonomics_tpu/cli/gtf_tools.py`` (106 lines, whole), gonomics'
``cmd/gtfTools``.

    gonomics-torch gtfTools filter in.gtf out.gtf [-geneNameList names]
        [-chromFilter chrom] [-codingTranscript]
    gonomics-torch gtfTools toBed in.gtf out.bed [-tss -chromSizeFile
        sizes [-merge]] [-firstTwoCodonBases]

With both ``-geneNameList`` and ``-chromFilter``, a listed gene passes
whatever its chrom and an unlisted one passes where all its transcripts
lie on the chrom. Plain ``toBed`` writes one 6-field bed a line of the
file, named ``source:feature`` and then every field from the score on,
joined with ``:``.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio
from ..io import chrom_info
from ..io import gtf as gtfio


def gtf_filter(in_file: str, out_file: str, *, gene_name_list: str = "",
               chrom_filter: str = "",
               coding_transcript: bool = False) -> None:
    """cmd/gtfTools/filter.go:63."""
    names = set(fileio.read(gene_name_list)) if gene_name_list else set()
    records = gtfio.read(in_file)
    with fileio.easy_create(out_file) as out:
        for gene in records.values():
            ok = True
            if coding_transcript:
                ok = any(e.cds is not None for t in gene.transcripts
                         for e in t.exons)
            if ok and gene_name_list and not chrom_filter:
                ok = gene.gene_name in names
            elif ok and chrom_filter and not gene_name_list:
                ok = all(t.chrom == chrom_filter
                         for t in gene.transcripts)
            elif ok and gene_name_list and chrom_filter:
                if gene.gene_name not in names:
                    ok = all(t.chrom == chrom_filter
                             for t in gene.transcripts)
            if ok:
                gtfio.write_gene(out, gene)


def gtf_to_bed(in_file: str, out_file: str, *, tss: bool = False,
               first_two_codon_bases: bool = False,
               chrom_size_file: str = "", merge: bool = False) -> None:
    """cmd/gtfTools/toBed.go:70."""
    if tss and first_two_codon_bases:
        raise SystemExit("Error: user cannot specify both tss and "
                         "firstTwoBasesOfCodons.")
    if tss and not chrom_size_file:
        raise SystemExit("Error: user must specify a chromSizes file to "
                         "convert to a Tss bed.")
    if tss:
        records = gtfio.read(in_file)
        sizes = chrom_info.read_to_map(chrom_size_file)
        bedio.write(out_file, gtfio.genes_to_tss_bed(records, sizes,
                                                     merge))
        return
    if first_two_codon_bases:
        bedio.write(out_file,
                    gtfio.genes_to_first_two_codon_bases(
                        gtfio.read(in_file)))
        return
    with fileio.easy_create(out_file) as out:
        for line in fileio.read(in_file):
            w = line.split("\t")
            name = w[1] + ":" + w[2]
            for i in range(5, len(w)):
                name += ":" + w[i]
            b = bedio.Bed(chrom=w[0], chrom_start=int(w[3]) - 1,
                          chrom_end=int(w[4]), name=name, score=0,
                          strand="-" if w[6] == "-" else "+",
                          fields_initialized=6)
            bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("Error: user must specify a gtfTools subcommand.")
    sub, rest = argv[0], argv[1:]
    if sub == "filter":
        p = argparse.ArgumentParser(prog="gtfTools filter")
        p.add_argument("input")
        p.add_argument("output")
        p.add_argument("-geneNameList", default="")
        p.add_argument("-chromFilter", default="")
        p.add_argument("-codingTranscript", action="store_true")
        a = p.parse_args(rest)
        gtf_filter(a.input, a.output, gene_name_list=a.geneNameList,
                   chrom_filter=a.chromFilter,
                   coding_transcript=a.codingTranscript)
    elif sub == "toBed":
        p = argparse.ArgumentParser(prog="gtfTools toBed")
        p.add_argument("input")
        p.add_argument("output")
        p.add_argument("-tss", action="store_true")
        p.add_argument("-firstTwoCodonBases", action="store_true")
        p.add_argument("-chromSizeFile", default="")
        p.add_argument("-merge", action="store_true")
        a = p.parse_args(rest)
        gtf_to_bed(a.input, a.output, tss=a.tss,
                   first_two_codon_bases=a.firstTwoCodonBases,
                   chrom_size_file=a.chromSizeFile, merge=a.merge)
    else:
        raise SystemExit(f"Error: unrecognized subcommand: {sub}.")


if __name__ == "__main__":
    main()
