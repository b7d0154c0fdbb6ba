"""multFaVisualizeBeds: a multFaVisualizer view a bed region; a copy
of ``gonomics_tpu/cli/mult_fa_visualize_beds.py`` (41 lines, whole),
gonomics' ``cmd/multFaVisualizeBeds``."""

from __future__ import annotations

import argparse

from .. import browser
from ..io import bed as bedio


def mult_fa_visualize_beds(bed_file: str, aln_file: str, out_format: bool,
                           no_mask: bool, line_length: int,
                           out_dir: str) -> None:
    """multFaVisualizeBeds.go:15-27: one output file per bed entry."""
    for b in bedio.read(bed_file):
        if out_format:
            out_file = f"{out_dir}{b.name}.txt"
        else:
            out_file = f"{out_dir}{b.chrom}_{b.chrom_start}_{b.chrom_end}.txt"
        browser.multi_fa_visualizer(aln_file, out_file, b.chrom_start,
                                    b.chrom_end, no_mask, line_length, False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multFaVisualizeBeds")
    p.add_argument("-noMask", action="store_true")
    p.add_argument("-outFormatName", action="store_true",
                   help="Uses the name column as the outfile name")
    p.add_argument("-lineLength", type=int, default=100)
    p.add_argument("-outDir", default="",
                   help='Path for output files, ending with "/"')
    p.add_argument("bed")
    p.add_argument("aln")
    a = p.parse_args(argv)
    mult_fa_visualize_beds(a.bed, a.aln, a.outFormatName, a.noMask,
                           a.lineLength, a.outDir)


if __name__ == "__main__":
    main()
