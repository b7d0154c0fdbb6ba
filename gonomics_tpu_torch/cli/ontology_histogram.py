"""ontologyHistogram: the number of genes on each ontology term across
GAF files; a copy of ``gonomics_tpu/cli/ontology_histogram.py`` (38
lines, whole), gonomics' ``cmdx/ontologyHistogram``.

    gonomics-torch ontologyHistogram in.obo gafFiles.txt out.tsv

Duplicate (GO id, symbol) pairs are removed within each GAF file only,
so a pair in two files counts twice; ids sort as strings; a term with
no gene is left out."""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..ontology import gaf as gafmod, obo as obomod, \
    gene_assignments_from_gaf, obo_to_ontology


def ontology_histogram(obo_file: str, gaf_files_index: str,
                       out_table: str) -> None:
    gaf_names = fileio.read(gaf_files_index)
    records, _ = obomod.read(obo_file, False)
    ont = obo_to_ontology(records)
    for gaf_file in gaf_names:
        this_gaf, _ = gafmod.read(gaf_file)
        gene_assignments_from_gaf(this_gaf, ont)
    ids = sorted(i for i in ont if len(ont[i].genes) != 0)
    with fileio.easy_create(out_table) as out:
        for i in ids:
            out.write(f"{i}\t{len(ont[i].genes)}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ontologyHistogram")
    p.add_argument("obo")
    p.add_argument("gafFiles")
    p.add_argument("out")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    ontology_histogram(a.obo, a.gafFiles, a.out)


if __name__ == "__main__":
    main()
