"""bedSplit: a bed file split into one file a name or a chrom; a copy of
``gonomics_tpu/cli/bed_split.py`` (47 lines).

    gonomics-torch bedSplit byName|byChrom in.bed outDir [-gzipOut]

``byName`` replaces ``/`` with ``_`` in the name that it writes and
names the file after it. ``-gzipOut`` writes ``.bed.gz`` through stdlib
gzip.
"""

from __future__ import annotations

import argparse
import os

from .. import fileio
from ..io import bed as bedio


def bed_split(mode: str, in_file: str, out_dir: str,
              gzip_out: bool = False) -> None:
    if mode not in ("byName", "byChrom"):
        raise SystemExit("Error: unrecognized mode. Mode may be either "
                         "'byChrom' or 'byName'.")
    os.makedirs(out_dir, exist_ok=True)
    ext = ".bed.gz" if gzip_out else ".bed"
    writers: dict[str, object] = {}
    try:
        for v in bedio.read(in_file):
            if mode == "byName":
                v.name = v.name.replace("/", "_")
                key = v.name
            else:
                key = v.chrom
            if key not in writers:
                writers[key] = fileio.easy_create(f"{out_dir}/{key}{ext}")
            bedio.write_to_handle(writers[key], v)
    finally:
        for w in writers.values():
            w.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedSplit")
    p.add_argument("mode")
    p.add_argument("input")
    p.add_argument("outDir")
    p.add_argument("-gzipOut", action="store_true")
    a = p.parse_args(argv)
    bed_split(a.mode, a.input, a.outDir, a.gzipOut)


if __name__ == "__main__":
    main()
