"""quickOrthologs: the TSS of each gene lifted through a chain file; a
copy of ``gonomics_tpu/cli/quick_orthologs.py`` (70 lines, whole),
gonomics' ``cmd/quickOrthologs``.

    gonomics-torch quickOrthologs [--canonicalTranscript] tName qName
        in.gtf t_q.chain t.sizes out.tsv unmapped.txt

A TSS (of every transcript, or with ``--canonicalTranscript`` of the
strictly longest one) of a gene with an empty name is skipped; one under
more than one chain, or under none, goes to the unmapped file after a
line that says why. Lines come in the order of the genes in the GTF.
"""

from __future__ import annotations

import argparse

from .. import fileio, interval
from ..io import chrom_info, formats
from ..io import gtf as gtfio
from .lift_coordinates import _ChainWrap, lift_with_chain


def quick_orthologs(t_name: str, q_name: str, gtf_file: str,
                    chain_file: str, chrom_sizes: str, out_file: str,
                    unmapped: str, *,
                    canonical_transcript: bool = False) -> None:
    genes = gtfio.read(gtf_file)
    chroms = chrom_info.read_to_map(chrom_sizes)
    if canonical_transcript:
        tss_beds = gtfio.genes_to_canonical_transcripts_tss_bed(genes, chroms)
    else:
        tss_beds = gtfio.genes_to_tss_bed(genes, chroms, False)
    chains, _ = formats.read_chain(chain_file)
    tree = interval.IntervalIndex([_ChainWrap(c) for c in chains])
    with fileio.easy_create(out_file) as out, \
            fileio.easy_create(unmapped) as un:
        out.write("#geneName\ttName\ttChrom\ttStart\ttEnd\tqName\tqChrom\t"
                  "qStart\tqEnd\n")
        for tss in tss_beds:
            if tss.name == "":
                continue
            overlap = tree.query(tss, "any")
            if len(overlap) > 1:
                un.write("Record below maps to multiple chains:\n")
                un.write(tss.to_string() + "\n")
            elif not overlap:
                un.write("Record below has no ortholog in new assembly:\n")
                un.write(tss.to_string() + "\n")
            else:
                chrom, start, end = lift_with_chain(
                    overlap[0].chain, tss.chrom_start, tss.chrom_end)
                out.write(f"{tss.name}\t{t_name}\t{tss.chrom}\t"
                          f"{tss.chrom_start}\t{tss.chrom_end}\t{q_name}\t"
                          f"{chrom}\t{start}\t{end}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="quickOrthologs")
    p.add_argument("--canonicalTranscript", action="store_true")
    p.add_argument("tName")
    p.add_argument("qName")
    p.add_argument("gtf")
    p.add_argument("chain")
    p.add_argument("sizes")
    p.add_argument("output")
    p.add_argument("unmapped")
    a = p.parse_args(argv)
    quick_orthologs(a.tName, a.qName, a.gtf, a.chain, a.sizes, a.output,
                    a.unmapped, canonical_transcript=a.canonicalTranscript)


if __name__ == "__main__":
    main()
