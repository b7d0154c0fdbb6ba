"""lastZWriter: lastZ pairwise job lines by contig; a copy of
``gonomics_tpu/cli/last_z_writer.py`` (44 lines, whole), gonomics'
``cmd/lastZWriter``."""

from __future__ import annotations

import argparse

from .. import lastz_writer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="lastZWriter")
    p.add_argument("-m", default=True,
                   type=lambda s: s.lower() != "false",
                   help="Use existing matrices at hardcoded path.")
    p.add_argument("-mPath", default="",
                   help="Path for created matrices if m = false.")
    p.add_argument("-simple", action="store_true",
                   help="Run simple lastZWriter.")
    p.add_argument("-parameters", default="",
                   help="Parameter string for simple mode, e.g. M=0")
    p.add_argument("-targetModifier", default="",
                   help="Target modifier, e.g. [unmask]")
    p.add_argument("lastZ")
    p.add_argument("pairwiseDir")
    p.add_argument("speciesList")
    p.add_argument("refList")
    p.add_argument("allDists")
    p.add_argument("outFile")
    a = p.parse_args(argv)

    if a.simple:
        lastz_writer.make_array_simple(a.lastZ, a.pairwiseDir,
                                       a.speciesList, a.refList,
                                       a.parameters, a.outFile,
                                       a.targetModifier)
    else:
        lastz_writer.make_array(a.lastZ, a.pairwiseDir, a.speciesList,
                                a.refList, a.allDists, a.outFile,
                                a.m, a.mPath, a.targetModifier)


if __name__ == "__main__":
    main()
