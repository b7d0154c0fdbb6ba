"""prcompFormat: the variable columns of a multiFa alignment as a one-hot
matrix for PCA, a copy of ``gonomics_tpu/cli/prcomp_format.py`` (46
lines), its flags unchanged.

    gonomics-torch prcompFormat [--verbose] in.fa out.txt

A column is dropped where any row holds a gap or N, or where every row
matches the first. ``--verbose`` is taken and ignored, as in the JAX
tool.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import fasta as fastaio

_ONE_HOT = {dna.A: "\t1\t0\t0\t0", dna.C: "\t0\t1\t0\t0",
            dna.G: "\t0\t0\t1\t0", dna.T: "\t0\t0\t0\t1"}


def prcomp_format(in_file: str, out_file: str) -> None:
    records = fastaio.read(in_file)
    mat = np.stack([dna.to_upper(r.seq) for r in records])
    invalid = (mat == dna.N) | (mat == dna.GAP)
    # keep columns where the first row is a real base, no row is gap/N,
    # and at least one row differs from the first (prcompFormat.go:37-63)
    all_match = (mat == mat[0]).all(axis=0)
    keep = ~invalid.any(axis=0) & ~all_match & ~invalid[0]
    sub = mat[:, keep]
    with fileio.easy_create(out_file) as out:
        header = "Sample" + "".join(
            f"\tVar_{n}" for n in range(4 * sub.shape[1]))
        out.write(header + "\n")
        for rec, row in zip(records, sub):
            out.write(rec.name
                      + "".join(_ONE_HOT[int(b)] for b in row) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="prcompFormat")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    prcomp_format(a.input, a.output)


if __name__ == "__main__":
    main()
