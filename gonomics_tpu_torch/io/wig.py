"""Fixed-step WIG records and writing, as ``bedToWig`` makes them: the
parts of ``gonomics_tpu/io/wig.py`` it uses (``Wig`` :21, ``go_fmt_g``
:31, ``make_skeleton`` :73, ``write_to_handle`` :104, ``write`` :123).

Values live in a float64 array a chromosome; writing skips runs of the
default value and starts a fresh fixedStep header after each, as
gonomics' ``wig.WriteToFileHandle`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import IO

import numpy as np

from .. import fileio
from .chrom_info import ChromInfo


@dataclass
class Wig:
    step_type: str = "fixedStep"
    chrom: str = ""
    start: int = 1
    step: int = 1
    span: int = -1   # -1 = missing
    default_value: float = 0.0
    values: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))


def go_fmt_g(x: float) -> str:
    """Go's %g of a float64: the shortest text that reads back equal."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    s = repr(float(x))
    if s.endswith(".0"):
        s = s[:-2]
    return s


def make_skeleton(chrom_sizes: dict[str, ChromInfo],
                  default_value: float = 0.0) -> dict[str, Wig]:
    """One record a chromosome, every value default_value."""
    return {name: Wig(chrom=name, default_value=default_value,
                      values=np.full(ci.size, default_value, np.float64))
            for name, ci in chrom_sizes.items()}


def write_to_handle(f: IO[str], rec: Wig) -> None:
    """The record's runs of non-default values, each under its own
    fixedStep header."""
    vals = np.asarray(rec.values)
    in_default = True
    for i in range(len(vals)):
        if vals[i] != rec.default_value:
            if in_default:
                in_default = False
                hdr = (f"fixedStep chrom={rec.chrom} start={rec.start + i} "
                       f"step={rec.step}")
                if rec.span != -1:
                    hdr += f" span={rec.span}"
                f.write(hdr + "\n")
            f.write(go_fmt_g(vals[i]) + "\n")
        else:
            in_default = True


def write(filename: str, records: dict[str, Wig]) -> None:
    """Every record, in sorted chromosome-name order."""
    with fileio.easy_create(filename) as f:
        for key in sorted(records):
            write_to_handle(f, records[key])
