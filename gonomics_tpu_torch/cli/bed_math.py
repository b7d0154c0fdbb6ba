"""bedMath: arithmetic on the float names of records that two bed files
share; a copy of ``gonomics_tpu/cli/bed_math.py`` (56 lines).

    gonomics-torch bedMath a.bed add|subtract|times|divideBy b.bed out.bed

Writes only A's records with an exact coordinate match in B, found by a
merge walk on ``bed.compare`` (chroms ordered as strings), so unsorted
input misses matches. The new name is written as ``:.8g``; dividing by a
zero name raises ZeroDivisionError.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio

_OPS = {
    "add": lambda a, b: a + b, "plus": lambda a, b: a + b,
    "subtract": lambda a, b: a - b, "minus": lambda a, b: a - b,
    "times": lambda a, b: a * b, "multiply": lambda a, b: a * b,
    "divide": lambda a, b: a / b, "divideby": lambda a, b: a / b,
}


def bed_math(a_file: str, op: str, b_file: str, out_file: str) -> None:
    fn = _OPS.get(op.lower())
    if fn is None:
        raise SystemExit(f"Unrecognized operation: {op}. Accepted "
                         "operations are add, subtract, times, or "
                         "divideBy.")
    a_recs, b_recs = bedio.read(a_file), bedio.read(b_file)
    if not a_recs:
        raise SystemExit("First bed file has no bed entries.")
    if not b_recs:
        raise SystemExit("Second bed file has no bed entries.")
    ai = bi = 0
    with fileio.easy_create(out_file) as out:
        while ai < len(a_recs) and bi < len(b_recs):
            a, b = a_recs[ai], b_recs[bi]
            if (a.chrom == b.chrom and a.chrom_start == b.chrom_start
                    and a.chrom_end == b.chrom_end):
                a.name = f"{fn(float(a.name), float(b.name)):.8g}"
                bedio.write_to_handle(out, a)
                ai += 1
            elif bedio.compare(a, b) < 0:
                ai += 1
            else:
                bi += 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedMath")
    p.add_argument("a")
    p.add_argument("op")
    p.add_argument("b")
    p.add_argument("output")
    a = p.parse_args(argv)
    bed_math(a.a, a.op, a.b, a.output)


if __name__ == "__main__":
    main()
