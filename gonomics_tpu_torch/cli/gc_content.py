"""gcContent: the GC content of a FASTA file over bed regions, a copy of
``gonomics_tpu/cli/gc_content.py`` (60 lines), its flags and defaults
unchanged.

    gonomics-torch gcContent regions.bed in.fa out.bed
        [-multiFaMode -multiFaSpecies name]

Each region is written with its percent GC in the name field, as ``%e``.
With ``-multiFaMode`` the regions are in record 0's coordinates of a
multiFa alignment, and the GC content is the named species' over the
columns they span; gaps and N are not counted.
"""

from __future__ import annotations

import argparse
import sys

from .. import fileio
from ..cli.fa_filter import gc_content
from ..io import bed as bedio, fasta as fastaio
from ..io.bed import Bed


def bed_gc_content(bed_file: str, fa_file: str, out_file: str,
                   multi_fa_mode: bool, species: str) -> None:
    records = fastaio.read(fa_file)
    recmap = {r.name: r.seq for r in records}
    with fileio.easy_create(out_file) as out:
        for cur in bedio.read(bed_file):
            if multi_fa_mode:
                if species not in recmap:
                    raise SystemExit(
                        f"Error: multiFaMode. Requested species ({species})"
                        f" was not found as a fasta record name in the "
                        f"input multi-fasta file")
                start = fastaio.ref_pos_to_aln_pos(records[0],
                                                   cur.chrom_start)
                end = fastaio.ref_pos_to_aln_pos(records[0], cur.chrom_end)
                gc = gc_content(recmap[species][start:end])
            else:
                if cur.chrom not in recmap:
                    raise SystemExit(
                        f"Error: bed region chrom ({cur.chrom}) was not "
                        f"found as a fasta record name in the input fasta "
                        f"file")
                gc = gc_content(
                    recmap[cur.chrom][cur.chrom_start:cur.chrom_end])
            ann = Bed(chrom=cur.chrom, chrom_start=cur.chrom_start,
                      chrom_end=cur.chrom_end, name=f"{gc:e}",
                      fields_initialized=4)
            bedio.write_to_handle(out, ann)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gcContent")
    p.add_argument("bed")
    p.add_argument("fa")
    p.add_argument("out")
    p.add_argument("-multiFaMode", action="store_true")
    p.add_argument("-multiFaSpecies", default="")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    if a.multiFaMode and not a.multiFaSpecies:
        raise SystemExit("Error: -multiFaMode was specified without "
                         "-multiFaSpecies")
    bed_gc_content(a.bed, a.fa, a.out, a.multiFaMode, a.multiFaSpecies)


if __name__ == "__main__":
    main()
