"""bedMerge: merge overlapping bed records, keeping the highest score; a
copy of ``gonomics_tpu/cli/bed_merge.py`` (57 lines), its flags and
defaults unchanged.

    gonomics-torch bedMerge in.bed out.bed [-mergeAdjacent] [-pad n]
        [-lowMem] [-keepAllNames]

``-lowMem`` merges in input order without sorting and ignores
``-keepAllNames``; ``-pad n`` merges records up to n bases apart (a
threshold of n + 1 on ``bed.minimum_distance``), ``-mergeAdjacent``
records that touch (bed_merge.py:48-52).
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio


def bed_merge(infile: str, outfile: str, merge_threshold: int = -1,
              low_mem: bool = False, keep_all_names: bool = False) -> None:
    if low_mem:
        records = bedio.read(infile)  # streaming semantics, eager IO
        with fileio.easy_create(outfile) as out:
            if not records:
                return
            cur = records[0]
            for b in records[1:]:
                dist = bedio.minimum_distance(cur, b)
                if bedio.overlap(cur, b) or (dist is not None
                                             and dist <= merge_threshold):
                    if b.score > cur.score:
                        cur.score = b.score
                    cur.chrom_end = max(b.chrom_end, cur.chrom_end)
                else:
                    bedio.write_to_handle(out, cur)
                    cur = b
            bedio.write_to_handle(out, cur)
        return
    records = bedio.read(infile)
    bedio.write(outfile, bedio.merge_high_mem(records, merge_threshold,
                                              keep_all_names))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedMerge")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-mergeAdjacent", action="store_true")
    p.add_argument("-pad", type=int, default=-1)
    p.add_argument("-lowMem", action="store_true")
    p.add_argument("-keepAllNames", action="store_true")
    a = p.parse_args(argv)
    pad = a.pad
    if pad > -1:
        pad += 1
    if a.mergeAdjacent and pad < 0:
        pad = 1
    bed_merge(a.input, a.output, pad, a.lowMem, a.keepAllNames)


if __name__ == "__main__":
    main()
