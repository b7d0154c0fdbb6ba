"""overlapEnrichments: enrichment and depletion p-values of the overlaps
between two sets of elements in a search space; a copy of
``gonomics_tpu/cli/overlap_enrichments.py`` (118 lines).

    gonomics-torch overlapEnrichments exact|normalApproximate|upperBound|
        lowerBound elements1 elements2 searchSpace out.tsv
        [-trimToSearchSpace [-relationship r]] [-secondFileList list]

Elements are beds or VCFs (``lift_enrichment.go_read``). Without
``-trimToSearchSpace`` an element outside the search space ends the
run; with it, each element is cut to the search-space regions it has
``-relationship`` to (default ``within``). Neither the search space nor
elements1 may overlap itself. A line a second file: the overlap count,
the method's check and expected overlap written ``:f``, the enrichment
``overlap / expected`` (ZeroDivisionError where the expected overlap is
0) and the two p-values written ``:e``.
"""

from __future__ import annotations

import argparse

from .. import fileio, interval
from .. import lift_enrichment as lift
from ..io import bed as bedio


def _ref_genome_trim(untrimmed, no_gap, relationship: str):
    """refGenomeTrim (overlapEnrichments.go:146)."""
    tree = interval.IntervalIndex(untrimmed)
    trimmed = []
    for region in no_gap:
        for hit in tree.query(region, relationship):
            trimmed.append(bedio.Bed(
                chrom=hit.chrom,
                chrom_start=max(hit.chrom_start, region.chrom_start),
                chrom_end=min(hit.chrom_end, region.chrom_end),
                fields_initialized=3))
    return trimmed


def _check_in_search_space(elements, search_space, message: str) -> None:
    tree = interval.IntervalIndex(search_space)
    for e in elements:
        if not tree.query(e, "any"):
            raise SystemExit(message)


def overlap_enrichments(method: str, in_file: str, second_file: str,
                        search_space_file: str, out_file: str, *,
                        trim_to_search_space: bool = False,
                        second_file_list: str = "",
                        relationship: str = "within") -> None:
    if method not in ("exact", "normalApproximate", "upperBound",
                      "lowerBound"):
        raise SystemExit(f"Error: unknown method. Found: {method}.")
    elements_one = lift.go_read(in_file)
    search_space = lift.go_read(search_space_file)
    if trim_to_search_space:
        elements_one = _ref_genome_trim(elements_one, search_space,
                                        relationship)
    else:
        _check_in_search_space(
            elements_one, search_space,
            "Error: foreground element from file 1 does not overlap "
            "search space. Please use 'trimToSearchSpace' to exclude "
            "this element.")
    lift.sort_by_coord(elements_one)
    lift.sort_by_coord(search_space)
    for recs, name in ((search_space, search_space_file),
                       (elements_one, in_file)):
        if lift.is_self_overlapping(recs):
            raise SystemExit("Elements in bedEnrichments must not be "
                             "self-overlapping. Self-overlap found in "
                             f"{name}.")

    second_files = ([second_file] if not second_file_list
                    else list(fileio.read(second_file_list)))
    with fileio.easy_create(out_file) as out:
        out.write("#Method\tFilename1\tFilename2\tLenElements1\t"
                  "LenElements2\tOverlapCount\tDebugCheck\t"
                  "ExpectedOverlap\tEnrichment\tEnrichPValue\t"
                  "DepletePValue\n")
        for curr in second_files:
            elements_two = lift.go_read(curr)
            if trim_to_search_space:
                elements_two = _ref_genome_trim(elements_two,
                                                search_space, relationship)
            else:
                _check_in_search_space(
                    elements_two, search_space,
                    "Error: foreground element from file 2 does not "
                    "overlap search space.")
            lift.sort_by_coord(elements_two)
            overlap = lift.overlap_count(elements_two, elements_one)
            if method == "exact":
                probs = lift.element_overlap_probabilities(
                    elements_one, elements_two, search_space)
                summary = lift.enrichment_p_value_exact(probs, overlap)
            elif method == "normalApproximate":
                probs = lift.element_overlap_probabilities(
                    elements_one, elements_two, search_space)
                summary = lift.enrichment_p_value_approximation(probs,
                                                                overlap)
            else:
                summary = lift.enrichment_p_value_bound(
                    elements_one, elements_two, search_space, overlap,
                    upper=method == "upperBound")
            out.write(f"{method}\t{in_file}\t{curr}\t"
                      f"{len(elements_one)}\t{len(elements_two)}\t"
                      f"{overlap}\t{summary[0]:f}\t{summary[1]:f}\t"
                      f"{overlap / summary[1]:f}\t{summary[2]:e}\t"
                      f"{summary[3]:e}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="overlapEnrichments")
    p.add_argument("method")
    p.add_argument("elements1")
    p.add_argument("elements2")
    p.add_argument("searchSpace")
    p.add_argument("output")
    p.add_argument("-trimToSearchSpace", action="store_true")
    p.add_argument("-secondFileList", default="")
    p.add_argument("-relationship", default="within")
    a = p.parse_args(argv)
    overlap_enrichments(a.method, a.elements1, a.elements2, a.searchSpace,
                        a.output, trim_to_search_space=a.trimToSearchSpace,
                        second_file_list=a.secondFileList,
                        relationship=a.relationship)


if __name__ == "__main__":
    main()
