"""bedFilter: bed records that pass bounds on score, length, position,
name and annotation; a copy of ``gonomics_tpu/cli/bed_filter.py`` (107
lines), its flags and defaults unchanged.

    gonomics-torch bedFilter in.bed out.bed [-minScore n] [-maxScore n]
        [-minLength n] [-maxLength n] [-minStart n] [-maxStart n]
        [-minEnd n] [-maxEnd n] [-minNameFloat x] [-maxNameFloat x]
        [-nameEquals s] [-nameNotEquals s] [-minAnnotationFloat x]
        [-maxAnnotationFloat x] [-annotationFilterField i] [-chrom c]
        [-subSet p] [-setSeed s]

A record of 4 fields or fewer fails any score bound that is set; a
name that is not a number raises ValueError under a name bound.
``-subSet`` keeps a record that passed every other test when a draw of
``np.random.default_rng(setSeed)`` is at most p: one draw a such record.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import fileio
from ..io import bed as bedio

MAX_INT = (1 << 63) - 1
MAX_F = sys.float_info.max


def bed_filter(in_file: str, out_file: str, *, min_score: int = -MAX_INT,
               max_score: int = MAX_INT, min_length: int = 0,
               max_length: int = MAX_INT, min_start: int = 0,
               max_start: int = MAX_INT, min_end: int = 0,
               max_end: int = MAX_INT, min_name_float: float = -MAX_F,
               max_name_float: float = MAX_F, name_equals: str = "",
               name_not_equals: str = "",
               min_annotation_float: float = -MAX_F,
               max_annotation_float: float = MAX_F,
               annotation_filter_field: int = 0, chrom: str = "",
               sub_set: float = 1.0, set_seed: int = 0) -> None:
    rng = np.random.default_rng(set_seed)
    with fileio.easy_create(out_file) as out:
        for b in bedio.read(in_file):
            length = b.chrom_end - b.chrom_start
            ok = True
            if b.fields_initialized > 4:
                if b.score < min_score or b.score > max_score:
                    ok = False
            elif min_score != -MAX_INT or max_score != MAX_INT:
                ok = False
            if not min_length <= length <= max_length:
                ok = False
            if not min_start <= b.chrom_start <= max_start:
                ok = False
            if not min_end <= b.chrom_end <= max_end:
                ok = False
            if min_name_float != -MAX_F and float(b.name) < min_name_float:
                ok = False
            if max_name_float != MAX_F and float(b.name) > max_name_float:
                ok = False
            if min_annotation_float != -MAX_F or \
                    max_annotation_float != MAX_F:
                if annotation_filter_field >= len(b.annotation):
                    raise SystemExit("annotationFilterField exceeds the "
                                     "number of annotation fields")
                v = float(b.annotation[annotation_filter_field])
                if v < min_annotation_float or v > max_annotation_float:
                    ok = False
            if chrom and b.chrom != chrom:
                ok = False
            if name_equals and b.name != name_equals:
                ok = False
            if name_not_equals and b.name == name_not_equals:
                ok = False
            if ok and sub_set < 1.0 and rng.random() > sub_set:
                ok = False
            if ok:
                bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-minScore", type=int, default=-MAX_INT)
    p.add_argument("-maxScore", type=int, default=MAX_INT)
    p.add_argument("-minLength", type=int, default=0)
    p.add_argument("-maxLength", type=int, default=MAX_INT)
    p.add_argument("-minStart", type=int, default=0)
    p.add_argument("-maxStart", type=int, default=MAX_INT)
    p.add_argument("-minEnd", type=int, default=0)
    p.add_argument("-maxEnd", type=int, default=MAX_INT)
    p.add_argument("-minNameFloat", type=float, default=-MAX_F)
    p.add_argument("-maxNameFloat", type=float, default=MAX_F)
    p.add_argument("-nameEquals", default="")
    p.add_argument("-nameNotEquals", default="")
    p.add_argument("-minAnnotationFloat", type=float, default=-MAX_F)
    p.add_argument("-maxAnnotationFloat", type=float, default=MAX_F)
    p.add_argument("-annotationFilterField", type=int, default=0)
    p.add_argument("-chrom", default="")
    p.add_argument("-subSet", type=float, default=1.0)
    p.add_argument("-setSeed", type=int, default=0)
    a = p.parse_args(argv)
    bed_filter(a.input, a.output, min_score=a.minScore, max_score=a.maxScore,
               min_length=a.minLength, max_length=a.maxLength,
               min_start=a.minStart, max_start=a.maxStart,
               min_end=a.minEnd, max_end=a.maxEnd,
               min_name_float=a.minNameFloat,
               max_name_float=a.maxNameFloat, name_equals=a.nameEquals,
               name_not_equals=a.nameNotEquals,
               min_annotation_float=a.minAnnotationFloat,
               max_annotation_float=a.maxAnnotationFloat,
               annotation_filter_field=a.annotationFilterField,
               chrom=a.chrom, sub_set=a.subSet, set_seed=a.setSeed)


if __name__ == "__main__":
    main()
