"""bedValueWig: each bed record annotated with the max, min or mean of
a fixed-step wig over its range; a copy of
``gonomics_tpu/cli/bed_value_wig.py`` (78 lines).

    gonomics-torch bedValueWig in.bed in.wig chrom.sizes out.bed [-min]
        [-average] [-normalize] [-noDataValue x]

Bases at ``-noDataValue`` (default the largest float64) are left out,
and a range with none else gets that value. ``-normalize`` divides by
step x the sum of the wig's other values. The value is appended as Go's
``%g`` and the record written with at least seven fields. The wig is
read by ``io/wig.read``: fixedStep only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import fileio
from ..io import bed as bedio
from ..io import wig as wigio


def _range_value(values: np.ndarray, start: int, end: int, no_data: float,
                 mode: str) -> float:
    window = values[start:end]
    data = window[window != no_data]
    if len(data) == 0:
        return no_data
    if mode == "min":
        return float(data.min())
    if mode == "average":
        return float(data.sum() / len(data))
    return float(data.max())


def bed_value_wig(in_file: str, wig_file: str, sizes_file: str,
                  out_file: str, *, norm: bool = False,
                  average: bool = False, use_min: bool = False,
                  no_data_value: float = sys.float_info.max) -> None:
    if use_min and average:
        raise SystemExit("Cannot select both min and average in the same "
                         "operation.")
    wig_data = wigio.read(wig_file, sizes_file, no_data_value)
    wig_total = 0.0
    if norm:
        for w in wig_data.values():
            vals = w.values[w.values != no_data_value]
            wig_total += float(w.step) * float(vals.sum())
    mode = "min" if use_min else ("average" if average else "max")
    with fileio.easy_create(out_file) as out:
        for b in bedio.read(in_file):
            if b.chrom not in wig_data:
                raise SystemExit(
                    f"Error: Chromosome for bed entry: {b.chrom}, not "
                    "found in reference genome specified by chrom sizes "
                    "file.")
            if b.fields_initialized < 7:
                b.fields_initialized = 7
            value = _range_value(wig_data[b.chrom].values, b.chrom_start,
                                 b.chrom_end, no_data_value, mode)
            if norm:
                value /= wig_total
            b.annotation = b.annotation + [wigio.go_fmt_g(value)]
            bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedValueWig")
    p.add_argument("input")
    p.add_argument("wig")
    p.add_argument("chromSizes")
    p.add_argument("output")
    p.add_argument("-min", action="store_true")
    p.add_argument("-average", action="store_true")
    p.add_argument("-normalize", action="store_true")
    p.add_argument("-noDataValue", type=float,
                   default=sys.float_info.max)
    a = p.parse_args(argv)
    bed_value_wig(a.input, a.wig, a.chromSizes, a.output,
                  norm=a.normalize, average=a.average, use_min=a.min,
                  no_data_value=a.noDataValue)


if __name__ == "__main__":
    main()
