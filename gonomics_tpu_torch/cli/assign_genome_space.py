"""assignGenomeSpace: the nearest gene for every base of a genome, by 1D
proximity or through 3D contacts; a copy of
``gonomics_tpu/cli/assign_genome_space.py`` (48 lines, whole), gonomics'
``cmd/assignGenomeSpace/assignGenomeSpace.go``.

    gonomics-torch assignGenomeSpace [--geneBed] [--proximity 1d.bed]
        [--contactFile contacts.bedpe --nearestGeneBed 3d.bed]
        genes.gtf chrom.sizes

The flags take two dashes. From a GTF the TSSs are merged
(``genes_to_tss_bed(genes, sizes, True)``); an empty contact file gives
the 1D fill."""

from __future__ import annotations

import argparse

from .. import ontology
from ..io import bed as bedio
from ..io import bedpe as bedpeio
from ..io import chrom_info
from ..io import gtf as gtfio


def assign_genome_space(gene_file: str, sizes_file: str, *,
                        contact_file: str = "", nearest_gene_bed: str = "",
                        gene_bed: bool = False, output_1d: str = "") -> None:
    sizes = chrom_info.read_to_map(sizes_file)
    if gene_bed:
        tss = bedio.read(gene_file)
    else:
        genes = gtfio.read(gene_file)
        tss = gtfio.genes_to_tss_bed(genes, sizes, True)
    if output_1d:
        bedio.write(output_1d, ontology.fill_space_no_hidden_value(tss, sizes))
    if contact_file:
        contacts = bedpeio.read(contact_file)
        nearest = ontology.fill_3d_space(contacts, tss, sizes)
        if nearest_gene_bed:
            bedio.write(nearest_gene_bed, nearest)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="assignGenomeSpace")
    p.add_argument("--nearestGeneBed", default="")
    p.add_argument("--geneBed", action="store_true")
    p.add_argument("--proximity", default="")
    p.add_argument("--contactFile", default="")
    p.add_argument("genes")
    p.add_argument("sizes")
    a = p.parse_args(argv)
    assign_genome_space(a.genes, a.sizes, contact_file=a.contactFile,
                        nearest_gene_bed=a.nearestGeneBed,
                        gene_bed=a.geneBed, output_1d=a.proximity)


if __name__ == "__main__":
    main()
