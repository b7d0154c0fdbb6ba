"""faToPredictSet: sliding windows of a FASTA file as a TSV of upper-case
sequences for a prediction set, a copy of
``gonomics_tpu/cli/fa_to_predict_set.py`` (41 lines), its double-dash
flags and defaults unchanged.

    gonomics-torch faToPredictSet [--windowSize 400] [--stride 1]
        [--withRevComp] in.fa out.txt

The windows start at ``range(0, len - window, stride)``, which leaves
out the last full window of a record (fa_to_predict_set.py:17).
"""

from __future__ import annotations

import argparse

from .. import dna, fileio
from ..io import fasta as fastaio


def fa_to_predict_set(in_file: str, out_file: str, *, window_size: int = 400,
                      stride: int = 1, with_rev_comp: bool = False) -> None:
    records = fastaio.read(in_file)
    with fileio.easy_create(out_file) as out:
        for rec in records:
            for j in range(0, len(rec.seq) - window_size, stride):
                name = f"{rec.name}:{j}-{j + window_size}"
                seq = dna.to_upper(rec.seq[j:j + window_size])
                if with_rev_comp:
                    rev = dna.reverse_complement(seq)
                    out.write(f"{name}\t{dna.to_string(seq)}\t"
                              f"{dna.to_string(rev)}\n")
                else:
                    out.write(f"{name}\t{dna.to_string(seq)}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faToPredictSet")
    p.add_argument("--windowSize", type=int, default=400)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--withRevComp", action="store_true")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    fa_to_predict_set(a.input, a.output, window_size=a.windowSize,
                      stride=a.stride, with_rev_comp=a.withRevComp)


if __name__ == "__main__":
    main()
