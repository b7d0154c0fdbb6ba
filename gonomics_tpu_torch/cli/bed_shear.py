"""bedShear: each bed record cut into fragments of a fixed size, the
last one shorter; a copy of ``gonomics_tpu/cli/bed_shear.py`` (36
lines).

    gonomics-torch bedShear in.bed out.bed [-fragmentSize 1]
"""

from __future__ import annotations

import argparse
from dataclasses import replace

from .. import fileio
from ..io import bed as bedio


def bed_shear(in_file: str, out_file: str, fragment_size: int) -> None:
    if fragment_size < 1:
        raise SystemExit("Error: fragmentSize must be a positive integer. "
                         f"Found: {fragment_size}.")
    with fileio.easy_create(out_file) as out:
        for v in bedio.read(in_file):
            for start in range(v.chrom_start, v.chrom_end, fragment_size):
                frag = replace(
                    v, chrom_start=start,
                    chrom_end=min(start + fragment_size, v.chrom_end))
                bedio.write_to_handle(out, frag)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedShear")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-fragmentSize", type=int, default=1)
    a = p.parse_args(argv)
    bed_shear(a.input, a.output, a.fragmentSize)


if __name__ == "__main__":
    main()
