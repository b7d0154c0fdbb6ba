"""bedCountBam: the reads of an indexed BAM in each bed region; a copy of
``gonomics_tpu/cli/bed_count_bam.py`` (40 lines), its flags and defaults
unchanged.

    gonomics-torch bedCountBam in.bam regions.bed out.txt [-norm]

The BAM's index is ``<in.bam>.bai``. A region's reads are
``io/bai.seek_bam_region``'s, one a (name, first-in-pair flag).
``-norm`` writes the count over ``abs(start - end)`` as ``:f``, under
its own header line; a region of length 0 raises ZeroDivisionError.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bai as baiio
from ..io import bed as bedio


def bed_count_bam(in_bam: str, in_bed: str, out_file: str,
                  norm: bool = False) -> None:
    bai = baiio.read_bai(in_bam + ".bai")
    with fileio.easy_create(out_file) as out:
        out.write("bedRegion\tcountsPerBP\n" if norm
                  else "bedRegion\tcounts\n")
        for b in bedio.read(in_bed):
            hits = baiio.seek_bam_region(in_bam, bai, b.chrom,
                                         b.chrom_start, b.chrom_end)
            if norm:
                size = abs(b.chrom_start - b.chrom_end)
                out.write(f"{b.name}\t{len(hits) / size:f}\n")
            else:
                out.write(f"{b.name}\t{len(hits)}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedCountBam")
    p.add_argument("bam")
    p.add_argument("bed")
    p.add_argument("output")
    p.add_argument("-norm", action="store_true")
    a = p.parse_args(argv)
    bed_count_bam(a.bam, a.bed, a.output, a.norm)


if __name__ == "__main__":
    main()
