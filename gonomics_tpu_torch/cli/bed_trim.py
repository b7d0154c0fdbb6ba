"""bedTrim: each bed record shortened by a percent of its length, split
across both ends; a copy of ``gonomics_tpu/cli/bed_trim.py`` (44
lines).

    gonomics-torch bedTrim [-trimPercent 0] in.bed out.bed

The bases to remove round half away from zero (``int(x + 0.5)``, Go's
``math.Round``); an odd count's extra base comes off the start. A
record whose length falls to 0 or below is dropped.
"""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..io import bed as bedio


def bed_trim(trim_percent: int, in_bed: str, out_bed: str) -> None:
    with fileio.easy_create(out_bed) as out:
        for b in bedio.read(in_bed):
            size = b.chrom_end - b.chrom_start
            to_remove = int(size * (trim_percent / 100) + 0.5)
            if to_remove % 2 == 0:
                b.chrom_start += to_remove // 2
                b.chrom_end -= to_remove // 2
            else:
                b.chrom_start += to_remove // 2 + 1
                b.chrom_end -= to_remove // 2
            if b.chrom_end - b.chrom_start > 0:
                bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedTrim")
    p.add_argument("-trimPercent", type=int, default=0)
    p.add_argument("inBed")
    p.add_argument("outBed")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    if a.trimPercent < 0 or a.trimPercent > 100:
        raise SystemExit("Error: trimPercent must be an integer between 0 "
                         "and 100")
    bed_trim(a.trimPercent, a.inBed, a.outBed)


if __name__ == "__main__":
    main()
