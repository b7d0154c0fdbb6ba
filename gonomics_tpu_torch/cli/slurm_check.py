"""slurmCheck: check a SLURM job array's completion; a copy of
``gonomics_tpu/cli/slurm_check.py`` (65 lines, whole), gonomics'
``cmd/slurmCheck`` (still a work in progress there).

Parses a 'fancy' job-array file where each line embeds a
``{check-spec}`` block; field 3 of the block is the check type
(exists/exists+/line/line+) and field 4 the output file to check.
gonomics' tool only parses and prints the first line's parts,
reproduced here byte for byte.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

from .. import fileio


@dataclass
class SlurmCheckArray:
    begin: str
    out_to_check: str
    check_type: str
    end: str


def process_fancy_slurm_line(line: str) -> SlurmCheckArray:
    """cmd/slurmCheck/slurmCheck.go:46-69 processFancySlurmLine."""
    before, _, rest = line.partition("{")
    inner, _, end = rest.partition("}")
    fields = inner.split()
    return SlurmCheckArray(begin=before, out_to_check=fields[3],
                           check_type=fields[2], end=end)


def parse_the_input(filename: str) -> list[SlurmCheckArray]:
    """cmd/slurmCheck/slurmCheck.go:24-43 parseTheInput."""
    out: list[SlurmCheckArray] = []
    with fileio.easy_open(filename) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if len(line) == 0:
                raise SystemExit("empty line in file, please remove and "
                                 "rerun.")
            out.append(process_fancy_slurm_line(line))
    return out


def first_line_report(parsed: list[SlurmCheckArray]) -> str:
    """The reference main()'s Printf (slurmCheck.go:108-112)."""
    p = parsed[0]
    return (f"begin: {p.begin} \n out: {p.out_to_check} \n "
            f"check: {p.check_type} \n end: {p.end} \n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="slurmCheck")
    p.add_argument("input")
    a = p.parse_args(argv)
    sys.stdout.write(first_line_report(parse_the_input(a.input)))


if __name__ == "__main__":
    main()
