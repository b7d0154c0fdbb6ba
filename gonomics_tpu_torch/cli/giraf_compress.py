"""girafCompress: GIRAF <-> GIRAF.FE conversion; a copy of
``gonomics_tpu/cli/giraf_compress.py`` (35 lines, whole), gonomics'
``cmdx/girafCompress``. ``-decompress`` writes the input's name less
``.fe``; the strand column follows flag bit 8 (``io/binary_giraf.py``)."""

from __future__ import annotations

import argparse
import sys

from .. import graph as graphmod
from ..io import binary_giraf


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="girafCompress")
    p.add_argument("infile")
    p.add_argument("-decompress", action="store_true")
    p.add_argument("-ref", default="",
                   help="Reference graph (.gg) used for GIRAF alignment")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    if a.decompress:
        if not a.ref:
            raise SystemExit("ERROR: -ref required for decompression")
        if not a.infile.endswith(".fe"):
            raise SystemExit(f"ERROR: {a.infile} lacks .fe extension")
        g = graphmod.read(a.ref)
        binary_giraf.decompress_giraf(a.infile, a.infile[:-3], g)
    else:
        if not a.infile.endswith(".giraf"):
            raise SystemExit(f"ERROR: {a.infile} does not have .giraf "
                             f"extension")
        binary_giraf.compress_giraf(a.infile, a.infile + ".fe")


if __name__ == "__main__":
    main()
