"""bedSimilarity: the share of each bed file's records that overlap the
other's; a copy of ``gonomics_tpu/cli/bed_similarity.py`` (111 lines).

    gonomics-torch bedSimilarity a.bed b.bed out.txt
    gonomics-torch bedSimilarity -list files.txt out.txt
        [-matrixAverage m.txt | -matrixComponents m.txt]

A share counts the targets, de-duplicated by coordinates, that overlap
any query, over all the targets with their duplicates. ``-list`` skips a
pair whose two paths are equal, not one whose contents are. Shares are
written ``:f``.
"""

from __future__ import annotations

import argparse
import bisect

from .. import fileio
from ..io import bed as bedio


def _overlapped_count(targets: list[bedio.Bed],
                      queries: list[bedio.Bed]) -> int:
    """The unique-coordinate targets that overlap any query
    (interval.Unique, tools.go:121)."""
    by_chrom: dict[str, list[tuple[int, int]]] = {}
    for q in queries:
        by_chrom.setdefault(q.chrom, []).append((q.chrom_start,
                                                 q.chrom_end))
    for spans in by_chrom.values():
        spans.sort()
    hit: set[tuple[str, int, int]] = set()
    for t in targets:
        spans = by_chrom.get(t.chrom, [])
        i = bisect.bisect_left(spans, (t.chrom_end, -1))
        for s, e in spans[:i]:
            if e > t.chrom_start:
                hit.add((t.chrom, t.chrom_start, t.chrom_end))
                break
    return len(hit)


def interval_similarity(a: list[bedio.Bed], b: list[bedio.Bed]):
    """(A's share in B, B's share in A, their mean)
    (interval.IntervalSimilarity, tools.go:47)."""
    perc_a = _overlapped_count(a, b) / len(a)
    perc_b = _overlapped_count(b, a) / len(b)
    return perc_a, perc_b, (perc_a + perc_b) / 2


def _basename(path: str) -> str:
    return path.split("/")[-1]


def compare_two(bed_a: str, bed_b: str, out_file: str) -> None:
    a, b = bedio.read(bed_a), bedio.read(bed_b)
    a_name, b_name = _basename(bed_a), _basename(bed_b)
    pa, pb, avg = interval_similarity(a, b)
    with fileio.easy_create(out_file) as out:
        out.write(f"proportion overlaps of {a_name} in {b_name}\t"
                  f"proportion overlaps of {b_name} in {a_name}\t"
                  "bedSimilarityScore\n")
        out.write(f"{pa:f}\t{pb:f}\t{avg:f}\n")


def multiple_comparisons(list_file: str, out_file: str,
                         matrix_average: str = "",
                         matrix_components: str = "") -> None:
    files = list(fileio.read(list_file))
    data = [bedio.read(f) for f in files]
    names = [_basename(f) for f in files]
    out = fileio.easy_create(out_file)
    out.write("A\tB\tproportion overlaps of A in B\t"
              "proportion overlaps of B in A\tbedSimilarityScore\n")
    matrix_file = matrix_average or matrix_components
    out_matrix = fileio.easy_create(matrix_file) if matrix_file else None
    if out_matrix:
        out_matrix.write("\t".join(["x"] + names) + "\n")
    for i in range(len(files)):
        vals: list[float] = []
        for j in range(len(files)):
            if files[i] == files[j]:
                if out_matrix:
                    vals.append(1.0)
                continue
            pa, pb, avg = interval_similarity(data[i], data[j])
            if j > i:
                out.write(f"{names[i]}\t{names[j]}\t{pa:f}\t{pb:f}\t"
                          f"{avg:f}\n")
            if matrix_average:
                vals.append(avg)
            elif matrix_components:
                vals.append(pa)
        if out_matrix:
            out_matrix.write("\t".join([names[i]] + [f"{v:f}" for v in
                                                     vals]) + "\n")
    out.close()
    if out_matrix:
        out_matrix.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedSimilarity")
    p.add_argument("args", nargs="*")
    p.add_argument("-list", dest="list_file", default="")
    p.add_argument("-matrixAverage", default="")
    p.add_argument("-matrixComponents", default="")
    a = p.parse_args(argv)
    if a.matrixAverage and a.matrixComponents:
        raise SystemExit("-matrixAverage and -matrixComponents cannot be "
                         "used together")
    if a.list_file:
        multiple_comparisons(a.list_file, a.args[0], a.matrixAverage,
                             a.matrixComponents)
    else:
        compare_two(a.args[0], a.args[1], a.args[2])


if __name__ == "__main__":
    main()
