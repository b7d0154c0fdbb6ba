"""fastqReplaceSeq: replace a read's prefix where it matches a find
sequence; a copy of ``gonomics_tpu/cli/fastq_replace_seq.py`` (72
lines), its flags and defaults unchanged.

    gonomics-torch fastqReplaceSeq in.fq findReplace.txt out.fq
        [-replaceDelim "\\t"] [-replacedRecordsOnly]

Each line of the table is a find and a replace sequence of one length.
Only the read's start is matched, and the first matching pair wins.
``-ignoreCase`` is ``store_true`` with default True, so it cannot be
turned off. A find sequence longer than a read exits; so does a run that
replaced nothing, after its output is written.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import fastq as fastqio


def _matches(seq: np.ndarray, find: np.ndarray, ignore_case: bool) -> bool:
    if len(find) > len(seq):
        raise SystemExit("Error: Length of find sequence must be less then "
                         "or equal to length of query sequence.")
    head = seq[:len(find)]
    if ignore_case:
        return bool((dna.to_upper(head) == dna.to_upper(find)).all())
    return bool((head == find).all())


def fastq_replace_seq(in_file: str, find_replace_file: str, out_file: str,
                      *, delim: str = "\t", ignore_case: bool = True,
                      replaced_records_only: bool = False) -> None:
    pairs = []
    for line in fileio.read(find_replace_file):
        cols = line.split(delim)
        if len(cols) != 2:
            raise SystemExit(f'Error: the following line:\n"{line}"\ndoes '
                             f'not give two substrings when split with '
                             f'"{delim}"')
        if len(cols[0]) != len(cols[1]):
            raise SystemExit("Error: find sequence must be same length as "
                             "replace sequence.")
        pairs.append((dna.from_string(cols[0]), dna.from_string(cols[1])))

    replaced = 0
    with fileio.easy_create(out_file) as out:
        for rec in fastqio.read(in_file):
            found = False
            for find, repl in pairs:
                if _matches(rec.seq, find, ignore_case):
                    rec.seq = np.array(rec.seq, copy=True)
                    rec.seq[:len(repl)] = repl
                    replaced += 1
                    fastqio.write_to_handle(out, rec)
                    found = True
                    break
            if not found and not replaced_records_only:
                fastqio.write_to_handle(out, rec)
    if replaced == 0:
        raise SystemExit("Error: No pattern(s) found in input file.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="fastqReplaceSeq")
    p.add_argument("input")
    p.add_argument("findReplaceFile")
    p.add_argument("output")
    p.add_argument("-replaceDelim", default="\t")
    p.add_argument("-ignoreCase", action="store_true", default=True)
    p.add_argument("-replacedRecordsOnly", action="store_true")
    a = p.parse_args(argv)
    fastq_replace_seq(a.input, a.findReplaceFile, a.output,
                      delim=a.replaceDelim, ignore_case=a.ignoreCase,
                      replaced_records_only=a.replacedRecordsOnly)


if __name__ == "__main__":
    main()
