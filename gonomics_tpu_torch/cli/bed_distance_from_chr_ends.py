"""bedDistanceFromChrEnds: each bed record scored by its distance to the
nearer end of its chromosome; a copy of
``gonomics_tpu/cli/bed_distance_from_chr_ends.py`` (40 lines).

    gonomics-torch bedDistanceFromChrEnds in.bed chrom.sizes out.bed

The score is min(size - end, start), and records of fewer than five
fields are written with five.
"""

from __future__ import annotations

import argparse

from ..io import bed as bedio
from ..io import chrom_info


def bed_distance_from_chr_ends(in_file: str, chrom_file: str,
                               out_file: str) -> None:
    records = bedio.read(in_file)
    ref = chrom_info.read_to_map(chrom_file)
    for r in records:
        if r.chrom not in ref:
            raise SystemExit(f"Did not find '{r.chrom}' in the chrom.sizes "
                             "file")
        from_end = ref[r.chrom].size - r.chrom_end
        if from_end < 0:
            raise SystemExit("inputBed coordinates are outside chrom.sizes "
                             "coordinate range")
        r.score = min(from_end, r.chrom_start)
        if r.fields_initialized < 5:
            r.fields_initialized = 5
    bedio.write(out_file, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedDistanceFromChrEnds")
    p.add_argument("input")
    p.add_argument("chromSizes")
    p.add_argument("output")
    a = p.parse_args(argv)
    bed_distance_from_chr_ends(a.input, a.chromSizes, a.output)


if __name__ == "__main__":
    main()
