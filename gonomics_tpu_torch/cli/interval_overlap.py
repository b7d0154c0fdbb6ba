"""intervalOverlap: the records of a bed or VCF file that do, or do
not, stand in a relationship to a set of selected regions; a copy of
``gonomics_tpu/cli/interval_overlap.py`` (59 lines), its flags and
defaults unchanged.

    gonomics-torch intervalOverlap select.bed in.bed|in.vcf out
        [-relationship any] [-nonOverlap] [-aggregate] [-mergedOutput]
        [-thresholdOverlap f]

The relationships are ``interval.RELATIONSHIPS``; ``-aggregate`` merges
the selected regions first, ``-mergedOutput`` writes each hit beside
its query.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..interval import (IntervalIndex, interval_size, merge_intervals,
                        overlap_size, read_intervals, record_to_string)


def interval_overlap(select_file: str, in_file: str, out_file: str, *,
                     non_overlap: bool = False, aggregate: bool = False,
                     relationship: str = "any", merged_output: bool = False,
                     threshold_overlap: float = 0.0) -> None:
    selects = read_intervals(select_file)
    if aggregate:
        selects = merge_intervals(selects)
    index = IntervalIndex(selects)

    with fileio.easy_create(out_file) as out:
        for q in read_intervals(in_file):
            answer = index.query(q, relationship)
            if threshold_overlap > 0 and answer:
                if not any(overlap_size(a, q) / interval_size(q)
                           >= threshold_overlap for a in answer):
                    answer = []
            if merged_output:
                for a in answer:
                    out.write(f"{record_to_string(a)}\t"
                              f"{record_to_string(q)}\n")
            elif non_overlap:
                if not answer:
                    out.write(record_to_string(q) + "\n")
            else:
                if answer:
                    out.write(record_to_string(q) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="intervalOverlap")
    p.add_argument("select")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-nonOverlap", action="store_true")
    p.add_argument("-aggregate", action="store_true")
    p.add_argument("-relationship", default="any")
    p.add_argument("-mergedOutput", action="store_true")
    p.add_argument("-thresholdOverlap", type=float, default=0.0)
    a = p.parse_args(argv)
    interval_overlap(a.select, a.input, a.output, non_overlap=a.nonOverlap,
                     aggregate=a.aggregate, relationship=a.relationship,
                     merged_output=a.mergedOutput,
                     threshold_overlap=a.thresholdOverlap)


if __name__ == "__main__":
    main()
