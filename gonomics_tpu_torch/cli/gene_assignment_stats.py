"""geneAssignmentStats: how often a test bed's gene names agree with a
true contact bedpe's; a copy of
``gonomics_tpu/cli/gene_assignment_stats.py`` (84 lines).

    gonomics-torch geneAssignmentStats truth.bedpe test.bed matched.bed
        nonMatched.bed

The truth's A feet, each annotated with its feet's distance, are merged
(names joined by commas); each merged region is matched against the
test records that overlap it, and the share of regions with a name in
common is printed with Python's float repr. The reference's loop
variables carry over: a region gets one non-match row for each
overlapping test record visited before its match, and a non-match row
takes the region's last name and annotation. A region with no test
record overlapping it ends the run.
"""

from __future__ import annotations

import argparse

from .. import interval
from ..io import bed as bedio
from ..io import bedpe as bedpeio


def gene_assignment_check_guide_pers(truth, test):
    """GeneAssignmentCheckGuidePers (geneAssignmentStats.go:127): (the
    matched share, the matched beds, the non-matched beds)."""
    bedpeio.annotate_feet_dist(truth)
    truth_beds = [
        bedio.Bed(chrom=t.a.chrom, chrom_start=t.a.chrom_start,
                  chrom_end=t.a.chrom_end, name=t.a.name,
                  annotation=list(t.a.annotation), fields_initialized=7)
        for t in truth]
    merged = bedio.merge_beds_keep_names_and_annotations(truth_beds)

    tree = interval.IntervalIndex(test)
    match_count = 0
    matches: list[bedio.Bed] = []
    non_matches: list[bedio.Bed] = []
    for mt in merged:
        matched = False
        nearest = tree.query(mt, "any")
        if not nearest:
            raise SystemExit("No overlap found for guide")
        for nb in nearest:
            names = mt.name.split(",")
            for ni, nm in enumerate(names):
                if not matched and nm == nb.name:
                    match_count += 1
                    matched = True
                    matches.append(bedio.Bed(
                        chrom=mt.chrom, chrom_start=mt.chrom_start,
                        chrom_end=mt.chrom_end, name=f"{nm},{nb.name}",
                        fields_initialized=7,
                        annotation=[mt.annotation[ni]]))
            if not matched:
                last = len(names) - 1
                non_matches.append(bedio.Bed(
                    chrom=mt.chrom, chrom_start=mt.chrom_start,
                    chrom_end=mt.chrom_end,
                    name=f"{names[last]},{nb.name}",
                    fields_initialized=7,
                    annotation=[mt.annotation[last]]))
    return match_count / len(merged), matches, non_matches


def gene_assignment_stats(in_contacts: str, in_test_bed: str,
                          out_matched: str, out_non_matched: str) -> None:
    truth = bedpeio.read(in_contacts)
    test = bedio.read(in_test_bed)
    freq, matched, non_matched = gene_assignment_check_guide_pers(truth,
                                                                  test)
    bedio.write(out_matched, matched)
    bedio.write(out_non_matched, non_matched)
    print(freq)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="geneAssignmentStats")
    p.add_argument("trueBedpe")
    p.add_argument("testBed")
    p.add_argument("matchedBed")
    p.add_argument("nonMatchedBed")
    a = p.parse_args(argv)
    gene_assignment_stats(a.trueBedpe, a.testBed, a.matchedBed,
                          a.nonMatchedBed)


if __name__ == "__main__":
    main()
