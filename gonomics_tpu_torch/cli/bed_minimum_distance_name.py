"""bedMinimumDistanceName: each input record scored by its distance to
the genome record of the same name; a copy of
``gonomics_tpu/cli/bed_minimum_distance_name.py`` (59 lines).

    gonomics-torch bedMinimumDistanceName input.bed genome.bed out.bed

The score is ``bed.minimum_distance(genome, input)``, in that order. The
strand is "-" for an input upstream of a "+" genome record (its start at
or before the genome's) or downstream of a "-" one (its end at or past
the genome's), else "+"; a genome record of strand "." exits. Records of
fewer than six fields are written with six.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio


def _upstream_downstream(input_bed: bedio.Bed,
                         genome_bed: bedio.Bed) -> str:
    if genome_bed.strand == "+":
        return ("-" if input_bed.chrom_start <= genome_bed.chrom_start
                else "+")
    if genome_bed.strand == "-":
        return ("-" if input_bed.chrom_end >= genome_bed.chrom_end
                else "+")
    raise SystemExit("problem with genomeBed strand")


def bed_minimum_distance_name(input_bed: str, genome_bed: str,
                              out_bed: str) -> None:
    inputs = bedio.read(input_bed)
    genome = bedio.read(genome_bed)
    genome_map: dict[str, bedio.Bed] = {}
    for g in genome:
        if g.name in genome_map:
            raise SystemExit("The following entry (Name field) is found "
                             f"twice in the bed: {g.name}")
        genome_map[g.name] = g
    with fileio.easy_create(out_bed) as out:
        for rec in inputs:
            if rec.name not in genome_map:
                raise SystemExit("Did not find genomeBed match for: "
                                 f"{rec.name}")
            g = genome_map[rec.name]
            dist = bedio.minimum_distance(g, rec)
            if dist is None:
                raise SystemExit("Unable to compare distance")
            rec.score = dist
            rec.strand = _upstream_downstream(rec, g)
            if rec.fields_initialized < 6:
                rec.fields_initialized = 6
            bedio.write_to_handle(out, rec)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedMinimumDistanceName")
    p.add_argument("inputBed")
    p.add_argument("genomeBed")
    p.add_argument("outputBed")
    a = p.parse_args(argv)
    bed_minimum_distance_name(a.inputBed, a.genomeBed, a.outputBed)


if __name__ == "__main__":
    main()
