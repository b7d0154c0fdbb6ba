"""oboTools, gafFilter and ontologyEnrichment; a copy of
``gonomics_tpu/cli/ontology_tools.py`` (97 lines, whole), gonomics'
``cmd/{oboTools,gafFilter,ontologyEnrichment}``. The umbrella runs
``main_obo_tools``, ``main_gaf_filter`` and
``main_ontology_enrichment``.

    gonomics-torch oboTools mapping in.obo out.tsv [-force]
    gonomics-torch gafFilter in.gaf out.gaf [-removeNot]
    gonomics-torch ontologyEnrichment queries.bed chrom.sizes genes.gtf
        annotations.gaf in.obo out.bed [-contactFile contacts.bedpe]

``-removeNot`` drops a record whose qualifier holds ``NOT`` anywhere.
``-geneEnrichments`` and ``-termEnrichments`` are ``store_true`` with a
default of True, so neither can be turned off."""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..io import bed as bedio
from ..io import bedpe as bedpeio
from ..io import chrom_info
from ..ontology import gaf as gafmod
from ..ontology import obo as obomod
from ..ontology import three_d_great


def obo_tools_mapping(in_file: str, out_file: str,
                      force: bool = False) -> None:
    """cmd/oboTools/mapping.go:53."""
    records, _ = obomod.read(in_file, force)
    with fileio.easy_create(out_file) as out:
        for term in records.values():
            out.write(f"{term.id}\t{term.name}\n")


def gaf_filter(in_file: str, out_file: str,
               remove_not: bool = False) -> None:
    """cmd/gafFilter/gafFilter.go."""
    records, header = gafmod.read(in_file)
    with fileio.easy_create(out_file) as out:
        for line in header:
            out.write(line + "\n")
        for g in records:
            if remove_not and "NOT" in g.qualifier:
                continue
            out.write(g.to_string() + "\n")


def ontology_enrichment(input_file: str, chrom_sizes: str, gene_file: str,
                        annotations_file: str, obo_file: str,
                        enrichment_out: str, *, force: bool = False,
                        contact_file: str = "",
                        gene_proportions: bool = True,
                        term_enrichments: bool = True) -> None:
    """cmd/ontologyEnrichment/ontologyEnrichment.go:16."""
    queries = bedio.read(input_file)
    sizes = chrom_info.read_to_map(chrom_sizes)
    contacts = None
    if contact_file:
        contacts = bedpeio.read(contact_file)
    annotations, _ = gafmod.read(annotations_file)
    obos, _ = obomod.read(obo_file, force)
    three_d_great(queries, sizes, gene_file, contacts, annotations, obos,
                  enrichment_out, gene_proportions, term_enrichments)


def main_obo_tools(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "mapping":
        raise SystemExit("Error: unrecognized or missing oboTools "
                         "subcommand (available: mapping).")
    p = argparse.ArgumentParser(prog="oboTools mapping")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-force", action="store_true")
    a = p.parse_args(argv[1:])
    obo_tools_mapping(a.input, a.output, a.force)


def main_gaf_filter(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gafFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-removeNot", action="store_true")
    a = p.parse_args(argv)
    gaf_filter(a.input, a.output, a.removeNot)


def main_ontology_enrichment(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ontologyEnrichment")
    p.add_argument("input")
    p.add_argument("chromSizes")
    p.add_argument("geneFile")
    p.add_argument("annotations")
    p.add_argument("obo")
    p.add_argument("output")
    p.add_argument("-force", action="store_true")
    p.add_argument("-contactFile", default="")
    p.add_argument("-geneEnrichments", action="store_true", default=True)
    p.add_argument("-termEnrichments", action="store_true", default=True)
    a = p.parse_args(argv)
    ontology_enrichment(a.input, a.chromSizes, a.geneFile, a.annotations,
                        a.obo, a.output, force=a.force,
                        contact_file=a.contactFile,
                        gene_proportions=a.geneEnrichments,
                        term_enrichments=a.termEnrichments)
