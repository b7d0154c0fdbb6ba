"""catMultiFa: multiFa files joined row by row, a copy of
``gonomics_tpu/cli/cat_multi_fa.py`` (55 lines), its flags and defaults
unchanged.

    gonomics-torch catMultiFa a.fa b.fa ... [-o stdout] [-lineLength 50]
    gonomics-torch catMultiFa -list files.txt [-o stdout]

Every file must hold the same names in the same order. The default
``-o`` is a file named ``stdout``, as in the JAX tool.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import fileio
from ..io import fasta as fastaio


def cat_multi_fa(file_list: list[str], out_file: str,
                 line_length: int = 50) -> None:
    if not file_list:
        raise SystemExit("Must provide at least one file to cat. "
                         "File list is empty.")
    ans = fastaio.read(file_list[0])
    for fname in file_list[1:]:
        curr = fastaio.read(fname)
        if len(curr) != len(ans):
            raise SystemExit(
                f"Each file to be concatenated must have the same number "
                f"of entries. Expected {len(ans)}, found {len(curr)} in "
                f"the file named {fname}.")
        for j, rec in enumerate(curr):
            if rec.name != ans[j].name:
                raise SystemExit(
                    f"Each file to be concatenated must contain the same "
                    f"names in the same order. Expected {ans[j].name}, "
                    f"found {rec.name} in the file named {fname}.")
            ans[j].seq = np.concatenate([ans[j].seq, rec.seq])
    fastaio.write(out_file, ans, line_length=line_length)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="catMultiFa")
    p.add_argument("inputs", nargs="*")
    p.add_argument("-o", default="stdout")
    p.add_argument("-list", dest="list_file", default="")
    p.add_argument("-lineLength", type=int, default=50)
    a = p.parse_args(argv)
    if a.list_file:
        if a.inputs:
            raise SystemExit("catMultiFa accepts either files as arguments "
                             "or a list of files with the -list option.")
        files = [ln for ln in fileio.read(a.list_file)]
    else:
        files = a.inputs
    cat_multi_fa(files, a.o, a.lineLength)


if __name__ == "__main__":
    main()
