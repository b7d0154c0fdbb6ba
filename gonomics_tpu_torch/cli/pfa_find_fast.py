"""pfaFindFast: sliding-window probabilistic divergence over a pFasta
alignment; a copy of ``gonomics_tpu/cli/pfa_find_fast.py`` (206 lines,
whole), gonomics' ``cmd/pfaFindFast`` (pfaFindFast.go, efficient.go).

Same window algebra as faFindFast (the reference shares the
incrementWindowEdge structure), but gap/N/substitution calls come from
pDna predicates: gap = all-zero vector, N = four equal non-zero entries,
substitution = 1 - dot product >= baseDotToSubstThreshold, plus a
confident-base count (max prob >= confidentThreshold). Every window is
an O(1) difference of prefix sums over per-base event vectors; the
dot products and the confidence test run in float32.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from .. import fileio, pdna
from ..io import pfasta
from ..numbers import binomial_dist_cache_log10

MAX_FLOAT64 = sys.float_info.max


def go_fmt_e(x: float) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    return f"{x:e}"


def _prefix(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


def speedy_window_difference(reference, first_query, second_query, *,
                             window_size: int, ref_chrom_name: str,
                             remove_n: bool, long_output: bool,
                             divergence_rate: float, output_aln_pos: bool,
                             base_dot_to_subst_threshold: float,
                             confident_threshold: float, out) -> None:
    fq = np.asarray(first_query, np.float32)
    sq = np.asarray(second_query, np.float32)
    ref = np.asarray(reference, np.float32)
    W = window_size

    p_cache = None
    if divergence_rate != MAX_FLOAT64:
        p_cache = binomial_dist_cache_log10(W, divergence_rate)

    fq_gap = pdna.is_gap(fq)
    sq_gap = pdna.is_gap(sq)
    fq_n_all = pdna.is_n(fq)
    sq_n_all = pdna.is_n(sq)

    base_pos = np.nonzero(~fq_gap)[0]
    K = len(base_pos)
    if K < W:
        return

    # per-base (k-indexed) event vectors at non-gap firstQuery positions
    fq_n = fq_n_all[base_pos].astype(np.int64)
    sq_n_match = sq_n_all[base_pos].astype(np.int64)
    # substitution: both non-gap and DotSubstProb >= threshold
    # (efficient.go:55-60); firstQuery is non-gap at base_pos already
    dot_sub = pdna.dot_subst_prob(fq[base_pos], sq[base_pos])
    subst = ((~sq_gap[base_pos])
             & (dot_sub >= base_dot_to_subst_threshold)).astype(np.int64)
    confident = pdna.is_confident(sq[base_pos],
                                  confident_threshold).astype(np.int64)
    sq_gap_b = sq_gap[base_pos]
    prev_sq_gap = np.concatenate(([False], sq_gap_b[:-1]))
    prev_exists = np.arange(K) > 0
    gap_opened2 = (sq_gap_b & (~prev_exists | ~prev_sq_gap)).astype(np.int64)
    gap_closed2 = (~sq_gap_b & prev_exists & prev_sq_gap).astype(np.int64)

    # firstQuery-gap run quantities strictly before each base
    c_ns_gap = _prefix((fq_gap & sq_n_all).astype(np.int64))
    c_oc_gap = _prefix((fq_gap & ~sq_gap).astype(np.int64))
    run_start = np.concatenate(([0], base_pos[:-1] + 1))
    run_ns_gap = c_ns_gap[base_pos] - c_ns_gap[run_start]
    run_gap_oc = (c_oc_gap[base_pos] - c_oc_gap[run_start] > 0).astype(
        np.int64)

    Csub = _prefix(subst)
    Cn_base = _prefix(fq_n + sq_n_match)
    Cr_ns = _prefix(run_ns_gap)
    Cr_oc = _prefix(run_gap_oc)
    Cop = _prefix(gap_opened2)
    Ccl = _prefix(gap_closed2)
    Cconf = _prefix(confident)

    ws = np.arange(K - W + 1)
    total_subst = Csub[ws + W] - Csub[ws]
    total_ns = (Cn_base[ws + W] - Cn_base[ws]) + (Cr_ns[ws + W]
                                                  - Cr_ns[ws + 1])
    total_gaps = (Cr_oc[ws + W] - Cr_oc[ws + 1]) + Cop[ws + W] - Ccl[ws + 1]
    total_confident = Cconf[ws + W] - Cconf[ws]

    ref_gap = pdna.is_gap(ref)
    c_ref = _prefix((~ref_gap).astype(np.int64))
    first_aln = base_pos[ws]
    last_aln = base_pos[ws + W - 1]
    chrom_start = c_ref[first_aln]
    chrom_end = c_ref[last_aln + 1]
    keep = ~(ref_gap[first_aln] | ref_gap[last_aln])
    if remove_n:
        keep &= total_ns == 0
    aln_pos_col = np.concatenate(([0], base_pos[:-1] + 1))[ws]

    name = ref_chrom_name
    for i in np.nonzero(keep)[0]:
        muts = int(total_subst[i] + total_gaps[i])
        s, e = int(chrom_start[i]), int(chrom_end[i])
        line = f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}"
        if long_output:
            if muts > W:
                raise ValueError(
                    "total number of mutations exceeds windowSize")
            pct = 100 * (muts / W)
            pval = p_cache.get(muts, 0.0) if p_cache is not None else 0.0
            line += (f"\t+\t{go_fmt_e(pct)}\t{go_fmt_e(pval)}"
                     f"\t{int(total_subst[i])}\t{int(total_gaps[i])}"
                     f"\t{e - s}\t{int(total_confident[i])}")
        if output_aln_pos:
            line += f"\t{int(aln_pos_col[i])}"
        out.write(line + "\n")


def pfa_find_fast(in_file: str, out_file: str, *,
                  first_query_name: str = "", second_query_name: str = "",
                  window_size: int = 1000, ref_chrom_name: str = "",
                  remove_n: bool = False, long_output: bool = False,
                  divergence_rate: float = MAX_FLOAT64,
                  output_aln_pos: bool = False,
                  base_dot_to_subst_threshold: float = 0.8,
                  confident_threshold: float = 0.8) -> None:
    records = pfasta.read(in_file)
    rec_map = pfasta.to_map(records)
    if len(records) < 2:
        raise SystemExit("Error: There must be at least 2 pFasta records "
                         "in the input file.")
    if first_query_name:
        if first_query_name not in rec_map:
            raise SystemExit("Error: first query name is not found in the "
                             "input file.")
        first_query = rec_map[first_query_name]
    else:
        first_query = records[0].seq
    if second_query_name:
        if second_query_name not in rec_map:
            raise SystemExit("Error: second query name is not found in the "
                             "input file.")
        second_query = rec_map[second_query_name]
    else:
        second_query = records[1].seq
    reference = records[0].seq
    if not (len(reference) == len(first_query) == len(second_query)):
        raise SystemExit("Error: Reference, first query, and second query "
                         "sequences are not all of equal length.")
    with fileio.easy_create(out_file) as out:
        speedy_window_difference(
            reference, first_query, second_query, window_size=window_size,
            ref_chrom_name=ref_chrom_name, remove_n=remove_n,
            long_output=long_output, divergence_rate=divergence_rate,
            output_aln_pos=output_aln_pos,
            base_dot_to_subst_threshold=base_dot_to_subst_threshold,
            confident_threshold=confident_threshold, out=out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pfaFindFast")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-firstQueryName", default="")
    p.add_argument("-secondQueryName", default="")
    p.add_argument("-windowSize", type=int, default=1000)
    p.add_argument("-chrom", default="")
    p.add_argument("-removeN", action="store_true")
    p.add_argument("-longOutput", action="store_true")
    p.add_argument("-divergenceRate", type=float, default=MAX_FLOAT64)
    p.add_argument("-outputAlnPos", action="store_true")
    p.add_argument("-baseDotToSubstThreshold", type=float, default=0.8)
    p.add_argument("-baseDistToDivThreshold", type=float, default=0.7)
    p.add_argument("-confidentThreshold", type=float, default=0.8)
    a = p.parse_args(argv)
    if a.divergenceRate != MAX_FLOAT64 and not (0 <= a.divergenceRate <= 1):
        raise SystemExit("Error: divergence rate must be a value between 0 "
                         "and 1.")
    pfa_find_fast(a.input, a.output, first_query_name=a.firstQueryName,
                  second_query_name=a.secondQueryName,
                  window_size=a.windowSize, ref_chrom_name=a.chrom,
                  remove_n=a.removeN, long_output=a.longOutput,
                  divergence_rate=a.divergenceRate,
                  output_aln_pos=a.outputAlnPos,
                  base_dot_to_subst_threshold=a.baseDotToSubstThreshold,
                  confident_threshold=a.confidentThreshold)


if __name__ == "__main__":
    main()
