"""bedGraphToWig: a bedGraph's values written as a fixed-step wig over
the chromosomes of a sizes file; a copy of
``gonomics_tpu/cli/bed_graph_to_wig.py`` (36 lines).

    gonomics-torch bedGraphToWig in.bedGraph chrom.sizes out.wig
        [-missingData 0]

Exits where two entries cover one base (a base already off
``-missingData``).
"""

from __future__ import annotations

import argparse

from ..io import bed_graph as bgio
from ..io import chrom_info, wig as wigio


def bed_graph_to_wig(in_file: str, chrom_file: str, out_file: str,
                     missing: float = 0.0) -> None:
    sizes = chrom_info.read_to_map(chrom_file)
    wig_map = wigio.make_skeleton(sizes, missing)
    for b in bgio.read(in_file):
        vals = wig_map[b.chrom].values
        if (vals[b.chrom_start:b.chrom_end] != missing).any():
            raise SystemExit("multiple bedGraph entries map to the same "
                             "position")
        vals[b.chrom_start:b.chrom_end] = b.data_value
    wigio.write(out_file, wig_map)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedGraphToWig")
    p.add_argument("input")
    p.add_argument("sizes")
    p.add_argument("output")
    p.add_argument("-missingData", type=float, default=0.0)
    a = p.parse_args(argv)
    bed_graph_to_wig(a.input, a.sizes, a.output, a.missingData)


if __name__ == "__main__":
    main()
