"""wigTools: the filter, peaks, math, stats and toTrainingSet
subcommands on fixed-step wigs; a copy of
``gonomics_tpu/cli/wig_tools.py`` (388 lines) with its ``smooth`` and
``pearson``, its subcommands, flags and defaults unchanged.

    gonomics-torch wigTools filter in.wig chrom.sizes out.wig [-chrom c]
    gonomics-torch wigTools peaks in.wig chrom.sizes out.bed
        [-threshold 20] [-findMinima]
    gonomics-torch wigTools math in.wig chrom.sizes out [one operation]
    gonomics-torch wigTools stats in.wig chrom.sizes noGap.bed out.txt
    gonomics-torch wigTools toTrainingSet in.wig genome.fa train validate
        test [-windowSize 400] [-stride 400] [-setSeed n]

Wigs are read by ``io/wig.read`` (fixedStep only). ``math`` seeds
numpy's global generator with ``-setSeed & 0x7FFFFFFF``, from which
``pearson`` draws its sample (``-sampleFrequency`` defaults to 0.001, so
a default run draws). Its count of operations leaves out
``-scalarDivide``, and the order of its branches decides which runs.
``smooth`` leaves out the last window, and writes the missing value
wherever a window holds one. ``-missingBed`` writes the current region
again at a chrom change; ``-bedMask`` past a chrom's end exits.
``peaks`` visits chroms in sorted order and truncates its scores;
``stats`` truncates values toward zero, and a negative one counts from
the histogram's end. ``toTrainingSet`` leaves out each entry's last full
window, shards with ``np.random.default_rng`` seeded with ``-setSeed``
(unseeded at -1), and writes Go's ``%g``.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io import wig as wigio

MAX_FLOAT = sys.float_info.max


def wig_filter(in_file: str, chrom_sizes: str, out_file: str, *,
               chrom: str = "", default_value: float = 0.0) -> None:
    """The records of the sizes file, only -chrom's if given."""
    records = wigio.read(in_file, chrom_sizes, default_value)
    answer = {k: w for k, w in records.items()
              if not (chrom and w.chrom != chrom)}
    wigio.write(out_file, answer)


def wig_peaks(in_wig: str, chrom_sizes: str, out_bed: str, *,
              threshold: float = 20.0, find_minima: bool = False,
              default_value: float = 0.0) -> None:
    """Each run of values at or past the threshold (at or below it with
    find_minima) as a bed record scored with its extreme, chroms in
    sorted order."""
    records = wigio.read(in_wig, chrom_sizes, default_value)
    out = fileio.easy_create(out_bed)
    for key in sorted(records):
        w = records[key]
        in_peak = False
        current = None
        pos = w.start
        for v in np.asarray(w.values):
            v = float(v)
            hit = v <= threshold if find_minima else v >= threshold
            if hit:
                if not in_peak:
                    in_peak = True
                    current = bedio.Bed(w.chrom, pos, pos + 1, "", int(v),
                                        fields_initialized=5)
                else:
                    current.chrom_end = pos + 1
                    if find_minima and v < current.score:
                        current.score = int(v)
                    elif not find_minima and v > current.score:
                        current.score = int(v)
            elif in_peak:
                in_peak = False
                bedio.write_to_handle(out, current)
            pos += w.step
        if in_peak:
            bedio.write_to_handle(out, current)
    out.close()


def smooth(w: wigio.Wig, window: int, missing: float) -> wigio.Wig:
    """The moving average of window values at each window's midpoint;
    missing where a window holds the missing value, and past the last
    window but one."""
    vals = np.asarray(w.values, np.float64)
    out = np.full(len(vals), missing, np.float64)
    for j in range(len(vals) - window):
        win = vals[j:j + window]
        if np.any(win == missing):
            continue
        out[(2 * j + window) // 2] = float(win.sum())/window
    return wigio.Wig(chrom=w.chrom, start=w.start, step=w.step, span=w.span,
                     default_value=w.default_value, values=out)


def pearson(alpha: dict, beta: dict, missing: float, freq: float) -> float:
    """Pearson's r of the two wigs over the positions where neither is
    missing, each kept where numpy's global draw is below freq (every
    one at freq 1, which still draws nothing)."""
    if not 0 <= freq <= 1:
        raise SystemExit("samplingFrequency must be between 0 and 1")
    a_all, b_all = [], []
    for key in sorted(alpha):
        if key not in beta:
            raise SystemExit(f"chrom {key} not found in second wig")
        av = np.asarray(alpha[key].values)
        bv = np.asarray(beta[key].values)
        if len(av) != len(bv):
            raise SystemExit("wig entries differ in length")
        keep = (av != missing) & (bv != missing)
        if freq < 1:
            keep &= np.random.random(len(av)) < freq
        a_all.append(av[keep])
        b_all.append(bv[keep])
    a = np.concatenate(a_all)
    b = np.concatenate(b_all)
    if len(a) == 0:
        raise SystemExit("cannot compute PCC for empty vectors")
    am, bm = a.mean(), b.mean()
    num = float(((a - am) * (b - bm)).sum())
    return num / (math.sqrt(float(((a - am) ** 2).sum()))
                  * math.sqrt(float(((b - bm) ** 2).sum())))


def wig_math(in_file: str, chrom_sizes: str, out_file: str, *,
             bed_mask: str = "", min_value: float = -MAX_FLOAT,
             max_value: float = MAX_FLOAT, scalar_multiply: float = 1.0,
             scalar_divide: float = 1.0, add_file: str = "",
             max_file: str = "", subtract_file: str = "",
             smoothing: int = 1, abs_error: str = "",
             abs_percent_error: str = "", missing: float = 0.0,
             missing_bed: bool = False, pearson_file: str = "",
             sampling_frequency: float = 0.001, seed: int = 1) -> None:
    """One operation a run, written to out_file."""
    np.random.seed(seed & 0x7FFFFFFF)
    records = wigio.read(in_file, chrom_sizes, missing)
    n_ops = sum([bed_mask != "", min_value > -MAX_FLOAT,
                 max_value < MAX_FLOAT, scalar_multiply != 1,
                 add_file != "", max_file != "", subtract_file != "",
                 missing_bed, smoothing > 1, abs_error != "",
                 abs_percent_error != "", pearson_file != ""])
    if n_ops > 1:
        raise SystemExit("wigTools math can perform only one mathematical "
                         "operation at a time.")

    def combine(second_file, fn):
        second = wigio.read(second_file, chrom_sizes, missing)
        for key, w in records.items():
            if key not in second:
                raise SystemExit(f"chrom {key} not found in second wig")
            a = np.asarray(w.values)
            b = np.asarray(second[key].values)
            ok = (a != missing) & (b != missing)
            w.values = np.where(ok, fn(a, b), missing)

    if scalar_multiply != 1:
        for w in records.values():
            v = np.asarray(w.values)
            w.values = np.where(v != missing, v * scalar_multiply, v)
        wigio.write(out_file, records)
    elif scalar_divide != 1:
        if scalar_divide == 0:
            raise SystemExit("cannot divide wig values by zero")
        for w in records.values():
            v = np.asarray(w.values)
            w.values = np.where(v != missing, v / scalar_divide, v)
        wigio.write(out_file, records)
    elif add_file:
        combine(add_file, lambda a, b: a + b)
        wigio.write(out_file, records)
    elif max_file:
        combine(max_file, np.maximum)
        wigio.write(out_file, records)
    elif subtract_file:
        combine(subtract_file, lambda a, b: a - b)
        wigio.write(out_file, records)
    elif smoothing > 1:
        records = {k: smooth(w, smoothing, missing)
                   for k, w in records.items()}
        wigio.write(out_file, records)
    elif abs_error:
        combine(abs_error, lambda a, b: np.abs(a - b))
        wigio.write(out_file, records)
    elif abs_percent_error:
        def ape(a, b):
            with np.errstate(divide="ignore", invalid="ignore"):
                r = np.abs((a - b) / a) * 100
            return np.where(a != 0, r, missing)
        combine(abs_percent_error, ape)
        wigio.write(out_file, records)
    elif pearson_file:
        second = wigio.read(pearson_file, chrom_sizes, missing)
        answer = pearson(records, second, missing, sampling_frequency)
        with fileio.easy_create(out_file) as out:
            out.write(f"PCC:\t{answer:f}\n")
    elif min_value > -MAX_FLOAT:
        for w in records.values():
            v = np.asarray(w.values)
            w.values = np.where((v != missing) & (v < min_value), missing, v)
        wigio.write(out_file, records)
    elif max_value < MAX_FLOAT:
        for w in records.values():
            v = np.asarray(w.values)
            w.values = np.where((v != missing) & (v > max_value), missing, v)
        wigio.write(out_file, records)
    elif missing_bed:
        out = fileio.easy_create(out_file)
        current = bedio.Bed("dummyPlaceHolder", -1, -1)
        in_missing = False
        for key in sorted(records):
            w = records[key]
            for pos, v in enumerate(np.asarray(w.values)):
                if v == missing:
                    if w.chrom != current.chrom and \
                            current.chrom != "dummyPlaceHolder":
                        bedio.write_to_handle(out, current)
                        current = bedio.Bed(w.chrom, pos, pos + 1)
                    elif in_missing:
                        current.chrom_end = pos + 1
                    else:
                        current = bedio.Bed(w.chrom, pos, pos + 1)
                        in_missing = True
                elif in_missing:
                    in_missing = False
                    bedio.write_to_handle(out, current)
        if current.chrom_start >= 0:
            bedio.write_to_handle(out, current)
        out.close()
    elif bed_mask:
        for b in bedio.read(bed_mask):
            vals = records[b.chrom].values
            if b.chrom_end > len(vals):
                raise SystemExit(f"position exceeds length of {b.chrom}")
            vals[b.chrom_start:b.chrom_end] = missing
        wigio.write(out_file, records)


def wig_stats(in_file: str, chrom_sizes: str, no_gap_file: str,
              out_file: str, *, missing: float = -math.inf) -> None:
    """The histogram of the values, truncated to int, over the noGap
    regions."""
    beds = bedio.read(no_gap_file)
    w = wigio.read(in_file, chrom_sizes, missing)
    stat = np.zeros(1000, np.int64)
    for b in beds:
        if b.chrom not in w:
            raise SystemExit(f"chrom {b.chrom} not in reference genome")
        vals = np.asarray(w[b.chrom].values[b.chrom_start:b.chrom_end])
        vals = vals[vals != missing]
        ints = vals.astype(np.int64)  # Go int() truncates toward zero
        if len(ints):
            hi = int(ints.max())
            if hi >= len(stat):
                stat = np.concatenate([stat,
                                       np.zeros(hi - len(stat) + 1,
                                                np.int64)])
            np.add.at(stat, ints, 1)
    with fileio.easy_create(out_file) as out:
        out.write("coverage\tcount\n")
        for i, c in enumerate(stat):
            out.write(f"{i}\t{c}\n")


def to_training_set(in_wig: str, in_fasta: str, train_file: str,
                    validate_file: str, test_file: str, *,
                    window_size: int = 400, stride: int = 400,
                    validation_prop: float = 0.1, testing_prop: float = 0.1,
                    seed: int = -1, missing: float = -10.0,
                    log_transform: bool = False,
                    include_rev_comp: bool = False,
                    no_header: bool = False) -> None:
    """A line a window whose midpoint has a value: its name, upper-case
    sequence and value, to the training, validation or test file by a
    draw."""
    rng = np.random.default_rng(seed if seed >= 0 else None)
    if validation_prop + testing_prop >= 1:
        raise SystemExit("pValidation + pTesting should sum to less "
                         "than one.")
    genome = fastaio.read(in_fasta)
    by_name = {f.name: f for f in genome}
    outs = [fileio.easy_create(p)
            for p in (train_file, test_file, validate_file)]
    train_out, test_out, validate_out = outs
    if not no_header:
        for o in outs:
            o.write("name\tseq\tvalue\n")
    for entry in wigio.read_entries(in_wig):
        if entry.chrom not in by_name:
            raise SystemExit(f"wig chromosome {entry.chrom} not in genome")
        fa = by_name[entry.chrom]
        vals = np.asarray(entry.values)
        for start in range(0, len(vals) - window_size, stride):
            mid = (2 * start + window_size) // 2
            if vals[mid] == missing:
                continue
            name = f"{entry.chrom}:{start}-{start + window_size}"
            seq = dna.to_upper(np.asarray(fa.seq[start:start + window_size]))
            value = math.log(vals[mid]) if log_transform else float(vals[mid])
            line = f"{name}\t{dna.to_string(seq)}\t{wigio.go_fmt_g(value)}\n"
            r = rng.random()
            if r < testing_prop:
                dest = test_out
            elif r < testing_prop + validation_prop:
                dest = validate_out
            else:
                dest = train_out
            dest.write(line)
            if include_rev_comp:
                rc = dna.reverse_complement(seq)
                dest.write(f"{name}_rev\t{dna.to_string(rc)}\t"
                           f"{wigio.go_fmt_g(value)}\n")
    for o in outs:
        o.close()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: wigTools <peaks|filter|math|stats|"
                         "toTrainingSet> ...")
    sub, rest = argv[0], argv[1:]
    p = argparse.ArgumentParser(prog=f"wigTools {sub}")
    if sub == "filter":
        p.add_argument("input"), p.add_argument("sizes")
        p.add_argument("output")
        p.add_argument("-chrom", default="")
        p.add_argument("-defaultValue", type=float, default=0.0)
        a = p.parse_args(rest)
        wig_filter(a.input, a.sizes, a.output, chrom=a.chrom,
                   default_value=a.defaultValue)
    elif sub == "peaks":
        p.add_argument("input"), p.add_argument("sizes")
        p.add_argument("output")
        p.add_argument("-threshold", type=float, default=20.0)
        p.add_argument("-findMinima", action="store_true")
        p.add_argument("-missingValue", type=float, default=0.0)
        a = p.parse_args(rest)
        wig_peaks(a.input, a.sizes, a.output, threshold=a.threshold,
                  find_minima=a.findMinima, default_value=a.missingValue)
    elif sub == "math":
        p.add_argument("input"), p.add_argument("sizes")
        p.add_argument("output")
        p.add_argument("-absoluteError", default="")
        p.add_argument("-absolutePercentError", default="")
        p.add_argument("-bedMask", default="")
        p.add_argument("-elementWiseAdd", default="")
        p.add_argument("-elementWiseMax", default="")
        p.add_argument("-elementWiseSubtract", default="")
        p.add_argument("-maxValue", type=float, default=MAX_FLOAT)
        p.add_argument("-minValue", type=float, default=-MAX_FLOAT)
        p.add_argument("-missing", type=float, default=0.0)
        p.add_argument("-missingBed", action="store_true")
        p.add_argument("-movingAverageSmoothing", type=int, default=1)
        p.add_argument("-pearson", default="")
        p.add_argument("-sampleFrequency", type=float, default=0.001)
        p.add_argument("-scalarDivide", type=float, default=1.0)
        p.add_argument("-scalarMultiply", type=float, default=1.0)
        p.add_argument("-setSeed", type=int, default=1)
        a = p.parse_args(rest)
        wig_math(a.input, a.sizes, a.output, bed_mask=a.bedMask,
                 min_value=a.minValue, max_value=a.maxValue,
                 scalar_multiply=a.scalarMultiply,
                 scalar_divide=a.scalarDivide, add_file=a.elementWiseAdd,
                 max_file=a.elementWiseMax,
                 subtract_file=a.elementWiseSubtract,
                 smoothing=a.movingAverageSmoothing,
                 abs_error=a.absoluteError,
                 abs_percent_error=a.absolutePercentError,
                 missing=a.missing, missing_bed=a.missingBed,
                 pearson_file=a.pearson,
                 sampling_frequency=a.sampleFrequency, seed=a.setSeed)
    elif sub == "stats":
        p.add_argument("input"), p.add_argument("sizes")
        p.add_argument("noGap"), p.add_argument("output")
        p.add_argument("-missingDataValue", type=float, default=-math.inf)
        a = p.parse_args(rest)
        wig_stats(a.input, a.sizes, a.noGap, a.output,
                  missing=a.missingDataValue)
    elif sub == "toTrainingSet":
        p.add_argument("input"), p.add_argument("genome")
        p.add_argument("train"), p.add_argument("validate")
        p.add_argument("test")
        p.add_argument("-windowSize", type=int, default=400)
        p.add_argument("-stride", type=int, default=400)
        p.add_argument("-validationProp", type=float, default=0.1)
        p.add_argument("-testingProp", type=float, default=0.1)
        p.add_argument("-setSeed", type=int, default=-1)
        p.add_argument("-missing", type=float, default=-10.0)
        p.add_argument("-logTransform", action="store_true")
        p.add_argument("-includeRevComp", action="store_true")
        p.add_argument("-noHeader", action="store_true")
        a = p.parse_args(rest)
        to_training_set(a.input, a.genome, a.train, a.validate, a.test,
                        window_size=a.windowSize, stride=a.stride,
                        validation_prop=a.validationProp,
                        testing_prop=a.testingProp, seed=a.setSeed,
                        missing=a.missing, log_transform=a.logTransform,
                        include_rev_comp=a.includeRevComp,
                        no_header=a.noHeader)
    else:
        raise SystemExit(f"unrecognized subcommand: {sub}")


if __name__ == "__main__":
    main()
