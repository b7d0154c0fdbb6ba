"""findAndReplace: the values of a file replaced by those of a
find/replace table, a copy of ``gonomics_tpu/cli/find_and_replace.py``
(86 lines), its flags and defaults unchanged.

    gonomics-torch findAndReplace in.txt pairs.txt out.txt
        [-inFileDelim TAB] [-findReplaceDelim TAB] [-column -1] [-regex]

The pairs apply in the table's order (the reference iterates a Go map).
Whole lines take plain substring replacement, ``-regex`` takes each key
as a pattern with a literal replacement, and ``-column n`` replaces one
field and joins the fields with tabs whatever ``-inFileDelim`` is.
"""

from __future__ import annotations

import argparse
import re
import sys

from .. import fileio


def _read_pairs(filename: str, delim: str) -> dict[str, str]:
    pairs: dict[str, str] = {}
    with fileio.easy_open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            words = line.split(delim)
            if len(words) != 2:
                raise SystemExit(
                    f'Error: the following line:\n"{line}"\ndoes not give '
                    f'two substrings when split with "{delim}"')
            if words[0] in pairs:
                raise SystemExit(f'Error: this key:"{words[0]}" is found '
                                 f'more than once in the findReplaceFile.')
            pairs[words[0]] = words[1]
    return pairs


def find_and_replace(in_file: str, in_delim: str, fr_file: str,
                     fr_delim: str, out_file: str, column: int,
                     regex: bool) -> None:
    if regex and column != -1:
        raise SystemExit("Error: Regex ignores columns.")
    pairs = _read_pairs(fr_file, fr_delim)
    patterns = {re.compile(k): v for k, v in pairs.items()} if regex else {}
    replaced = 0
    with fileio.easy_open(in_file) as f, \
            fileio.easy_create(out_file) as out:
        for line in f:
            line = line.rstrip("\n")
            if column == -1 and not regex:
                new = line
                for k, v in pairs.items():
                    new = new.replace(k, v)
            elif regex:
                new = line
                for pat, v in patterns.items():
                    # ReplaceAllLiteralString: replacement is literal
                    new = pat.sub(lambda _m, _v=v: _v, new)
            else:
                words = line.split(in_delim)
                new = line
                if words[column] in pairs:
                    words[column] = pairs[words[column]]
                    new = "\t".join(words)
            if new != line:
                replaced += 1
            out.write(new + "\n")
    if replaced == 0:
        raise SystemExit("Error: pattern(s) not found in input file.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="findAndReplace")
    p.add_argument("inFile")
    p.add_argument("findReplaceFile")
    p.add_argument("outFile")
    p.add_argument("-inFileDelim", default="\t")
    p.add_argument("-findReplaceDelim", default="\t")
    p.add_argument("-column", type=int, default=-1)
    p.add_argument("-regex", action="store_true")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    find_and_replace(a.inFile, a.inFileDelim, a.findReplaceFile,
                     a.findReplaceDelim, a.outFile, a.column, a.regex)


if __name__ == "__main__":
    main()
