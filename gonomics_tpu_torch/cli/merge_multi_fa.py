"""mergeMultiFa: two multiFa alignments that share their first record
merged into one; a port of ``gonomics_tpu/cli/merge_multi_fa.py`` (77
lines), its arguments and output unchanged.

    gonomics-torch mergeMultiFa a.fa b.fa out.fa

The two reference rows are walked together: a column where both hold a
gap, or neither, takes both files' columns (and exits where the codes
differ, case-sensitively); a gap in one alone takes that file's column
and gaps for the other's rows. The walk stops when either reference runs
out, dropping the other file's trailing columns. Where the JAX appends
each output column's codes one by one, the port walks the two reference
rows to index arrays and gathers every row at once.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import fasta as fastaio


def _merge_columns(ref_a: list[int], ref_b: list[int]):
    """(the column of A, the column of B) behind each output column, -1
    where that file contributes gaps."""
    cols_a: list[int] = []
    cols_b: list[int] = []
    pa = pb = 0
    while pa < len(ref_a) and pb < len(ref_b):
        a_gap, b_gap = ref_a[pa] == dna.GAP, ref_b[pb] == dna.GAP
        if a_gap == b_gap:
            if ref_a[pa] != ref_b[pb]:
                raise SystemExit(
                    f"Error in mergeMultiFa. Reference sequences at "
                    f"alignment position {pa} of the first file showed "
                    "different bases between the two files.")
            cols_a.append(pa)
            cols_b.append(pb)
            pa += 1
            pb += 1
        elif b_gap:
            cols_a.append(-1)
            cols_b.append(pb)
            pb += 1
        else:
            cols_a.append(pa)
            cols_b.append(-1)
            pa += 1
    return np.array(cols_a, np.int64), np.array(cols_b, np.int64)


def _gather(seq: np.ndarray, cols: np.ndarray) -> np.ndarray:
    out = np.asarray(seq, np.int8)[np.maximum(cols, 0)]
    out[cols < 0] = dna.GAP
    return out


def merge_multi_fa(in_a_file: str, in_b_file: str, out_file: str) -> None:
    in_a = fastaio.read(in_a_file)
    in_b = fastaio.read(in_b_file)
    if in_a[0].name != in_b[0].name:
        raise SystemExit(
            f"The first file reference name ({in_a[0].name}) does not "
            f"match the second file reference name ({in_b[0].name}).")
    for recs, which in ((in_a, "first"), (in_b, "second")):
        if len(recs) < 2:
            raise SystemExit(f"The {which} multiFa file has less than two "
                             "entries, and is therefore not a valid "
                             "multiFa.")
        for i in range(1, len(recs)):
            if len(recs[0].seq) != len(recs[i].seq):
                raise SystemExit(
                    f"In the {which} multiFa file, entry at index {i} is "
                    "not the same length as the reference sequence.")

    cols_a, cols_b = _merge_columns(np.asarray(in_a[0].seq).tolist(),
                                    np.asarray(in_b[0].seq).tolist())
    out = [fastaio.Fasta(r.name, _gather(r.seq, cols_a)) for r in in_a]
    out += [fastaio.Fasta(r.name, _gather(r.seq, cols_b)) for r in in_b[1:]]
    fastaio.write(out_file, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mergeMultiFa")
    p.add_argument("input1")
    p.add_argument("input2")
    p.add_argument("output")
    a = p.parse_args(argv)
    merge_multi_fa(a.input1, a.input2, a.output)


if __name__ == "__main__":
    main()
