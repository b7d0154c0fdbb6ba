"""Fixed-step WIG records, reading and writing, as ``bedToWig``,
``bedValueWig`` and ``bedGraphToWig`` use them: all of
``gonomics_tpu/io/wig.py`` (``Wig`` :21, ``go_fmt_g`` :31,
``read_entries`` :43, ``make_skeleton`` :73, ``read`` :80,
``write_to_handle`` :104, ``write`` :123).

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
from .chrom_info import ChromInfo, read_to_map


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


def read_entries(filename: str) -> list[Wig]:
    """The fixedStep entries of a wig file, in file order; ValueError on
    a variableStep header or a value before any header."""
    out: list[Wig] = []
    cur: Wig | None = None
    vals: list[float] = []
    with fileio.easy_open(filename) as f:
        for line in fileio.real_lines(f):
            if line.startswith("fixedStep"):
                if cur is not None:
                    cur.values = np.array(vals, np.float64)
                    out.append(cur)
                fields = line.split()
                kv = dict(x.split("=", 1) for x in fields[1:])
                cur = Wig(chrom=kv["chrom"], start=int(kv["start"]),
                          step=int(kv["step"]),
                          span=int(kv.get("span", -1)))
                vals = []
            elif line.startswith("variableStep"):
                raise ValueError("variableStep wig unsupported; convert to "
                                 "fixedStep first")
            else:
                if cur is None:
                    raise ValueError("wig file missing fixedStep header")
                vals.append(float(line))
    if cur is not None:
        cur.values = np.array(vals, np.float64)
        out.append(cur)
    return out


def make_skeleton(chrom_sizes: dict[str, ChromInfo],
                  default_value: float = 0.0) -> dict[str, Wig]:
    """One record a chromosome, every value default_value."""
    return {name: Wig(chrom=name, default_value=default_value,
                      values=np.full(ci.size, default_value, np.float64))
            for name, ci in chrom_sizes.items()}


def read(filename: str, chrom_size_file: str,
         default_value: float = 0.0) -> dict[str, Wig]:
    """A record a chromosome of the sizes file, every base default_value
    but those the wig's entries set, each value over step bases
    (wig.Read, wig.go:172). ValueError on an entry's chrom missing from
    the sizes, on values past a chromosome's end, and on a base set twice;
    a base whose value equals default_value counts as unset."""
    sizes = read_to_map(chrom_size_file)
    answer = make_skeleton(sizes, default_value)
    for entry in read_entries(filename):
        if entry.chrom not in answer:
            raise ValueError(f"chrom {entry.chrom} not in chrom sizes")
        tgt = answer[entry.chrom].values
        pos = entry.start - 1
        for v in entry.values:
            for _ in range(entry.step):
                if pos >= len(tgt):
                    raise ValueError("wig values exceed chrom length")
                if tgt[pos] != default_value:
                    raise ValueError("multiple wig entries map to the same "
                                     "genomic position")
                tgt[pos] = v
                pos += 1
    return answer


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
