"""bedToWig: bed records to a fixed-step wig; a copy of
``gonomics_tpu/cli/bed_to_wig.py`` (71 lines), its flags and defaults
unchanged.

    gonomics-torch bedToWig Reads|Name|Score|Annotation in.bed ref.sizes
        out.wig [-defaultValue x] [-useRange] [-annotationField i]

``Reads`` counts the records over each base. The other methods write a
record's value at its midpoint (start + end) // 2, or over its whole
range with ``-useRange``, and exit where two records share a midpoint
or a range overlaps. The default value is the largest float64.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import bed as bedio
from ..io import wig as wigio
from ..io.chrom_info import read_to_map

MAX_FLOAT64 = sys.float_info.max


def bed_to_wig(method: str, in_file: str, ref_file: str, out_file: str, *,
               default_value: float = MAX_FLOAT64, use_range: bool = False,
               annotation_field: int = 0) -> None:
    ref = read_to_map(ref_file)
    if method == "Reads":
        out = wigio.make_skeleton(ref, 0)
        for b in bedio.read(in_file):
            out[b.chrom].values[b.chrom_start:b.chrom_end] += 1
    elif method in ("Name", "Score", "Annotation"):
        out = wigio.make_skeleton(ref, default_value)
        for b in bedio.read(in_file):
            if method == "Name":
                v = float(b.name)
            elif method == "Score":
                v = float(b.score)
            else:
                if annotation_field >= len(b.annotation):
                    raise SystemExit("annotationField exceeds annotations")
                v = float(b.annotation[annotation_field])
            vals = out[b.chrom].values
            if use_range:
                if (vals[b.chrom_start:b.chrom_end] != default_value).any():
                    raise SystemExit("overlapping bed elements detected; run "
                                     "bedMerge and rerun")
                vals[b.chrom_start:b.chrom_end] = v
            else:
                mid = (b.chrom_end + b.chrom_start) // 2
                if vals[mid] != default_value:
                    raise SystemExit("two bed entries share the same "
                                     "midpoint")
                vals[mid] = v
    else:
        raise SystemExit(f"Unrecognized method. Expected 'Reads', 'Name', "
                         f"'Score', or 'Annotation'. Found: {method}.")
    wigio.write(out_file, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedToWig")
    p.add_argument("method")
    p.add_argument("input")
    p.add_argument("ref_sizes")
    p.add_argument("output")
    p.add_argument("-defaultValue", type=float, default=MAX_FLOAT64)
    p.add_argument("-useRange", action="store_true")
    p.add_argument("-annotationField", type=int, default=0)
    a = p.parse_args(argv)
    bed_to_wig(a.method, a.input, a.ref_sizes, a.output,
               default_value=a.defaultValue, use_range=a.useRange,
               annotation_field=a.annotationField)


if __name__ == "__main__":
    main()
