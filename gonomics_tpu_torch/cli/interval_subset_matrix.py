"""intervalSubsetMatrix: a matrix of which union regions each interval
file overlaps; a copy of ``gonomics_tpu/cli/interval_subset_matrix.py``
(84 lines).

    gonomics-torch intervalSubsetMatrix union.bed files.txt out.tsv
        [-fraction] [-markMultipleOverlaps multi.tsv]

A row a union region, named ``chrom:start-end`` and sorted as that
string (``chr1:100-200`` before ``chr1:20-30``; equal regions make one
row), a column a file of the list. A value is 1 where the file overlaps
the region, or with ``-fraction`` the overlapping bases over the
region's length, summed over the file's records; written with Go's
``%g``. As in the reference, the overlap size is computed only in
fraction mode, so without ``-fraction`` the ``-markMultipleOverlaps``
matrix stays all zeros (intervalSubsetMatrix.go:59-79).
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..interval import (IntervalIndex, chrom_end, chrom_of, chrom_start,
                        interval_size, overlap_size, read_intervals)
from ..io.wig import go_fmt_g


def _coords(rec) -> str:
    """interval.CoordsToString (interval/tools.go:13-15)."""
    return f"{chrom_of(rec)}:{chrom_start(rec)}-{chrom_end(rec)}"


def interval_subset_matrix(union_file: str, file_list_file: str,
                           out_file: str, fraction: bool = False,
                           mark_multiple_overlaps: str = "") -> None:
    union = read_intervals(union_file)
    files = fileio.read(file_list_file)
    tree = IntervalIndex(union)

    mat: dict[str, list[float]] = {}
    mat_multi: dict[str, list[float]] = {}
    for u in union:
        mat[_coords(u)] = [0.0] * len(files)
        if mark_multiple_overlaps:
            mat_multi[_coords(u)] = [0.0] * len(files)

    ov_size = 0  # set only in fraction mode, as in the reference
    for i, fname in enumerate(files):
        for j in read_intervals(fname):
            for k in tree.query(j, "any"):
                if fraction:
                    ov_size = overlap_size(k, j)
                    mat[_coords(k)][i] += ov_size / interval_size(k)
                else:
                    mat[_coords(k)][i] = 1.0
                if mark_multiple_overlaps and ov_size > 0:
                    mat_multi[_coords(k)][i] += 1

    header = "Region" + "".join(f"\t{f}" for f in files)
    keys = sorted(mat)

    def write_matrix(path: str, m: dict[str, list[float]]) -> None:
        with fileio.easy_create(path) as out:
            out.write(header + "\n")
            for key in keys:
                out.write(key + "".join(f"\t{go_fmt_g(v)}" for v in m[key])
                          + "\n")

    write_matrix(out_file, mat)
    if mark_multiple_overlaps:
        write_matrix(mark_multiple_overlaps, mat_multi)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="intervalSubsetMatrix")
    p.add_argument("union")
    p.add_argument("fileList")
    p.add_argument("output")
    p.add_argument("-fraction", action="store_true")
    p.add_argument("-markMultipleOverlaps", default="")
    a = p.parse_args(argv)
    interval_subset_matrix(a.union, a.fileList, a.output,
                           fraction=a.fraction,
                           mark_multiple_overlaps=a.markMultipleOverlaps)


if __name__ == "__main__":
    main()
