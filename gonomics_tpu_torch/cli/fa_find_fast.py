"""faFindFast: the count of differences between two aligned sequences in
each window of windowSize bases of the first, a copy of
``gonomics_tpu/cli/fa_find_fast.py`` (272 lines), its flags, defaults,
output bytes and exits unchanged.

    gonomics-torch faFindFast in.fa out.bed [-windowSize 1000]
        [-chrom name] [-firstQueryName n] [-secondQueryName n]
        [-removeN] [-longOutput -divergenceRate p] [-outputAlnPos]
        [-gcContent]

Records 0 and 1 of the multiFa alignment (or the named ones) are
compared; coordinates are record 0's. The short output takes one of
two ways, each writing the same bytes: the native scan
(``native.fa_find_windows``), else the numpy prefix sums below and
Python formatting. The JAX tool's third way, those prefix sums with
native formatting, is left out: it runs only when the native scan
overflows its buffer, which no input can make it do. Every window is a
difference of prefix sums over the first query's bases, with the window
algebra of gonomics' ``speedyWindowDifference``.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from .. import dna, fileio, native
from ..io import fasta
from ..numbers import binomial_dist_cache_log10

MAX_FLOAT64 = sys.float_info.max


def go_fmt_e(x: float) -> str:
    """Go fmt %e (verb 'e', prec 6) including Inf/NaN spellings."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    return f"{x:e}"


def _prefix(x: np.ndarray) -> np.ndarray:
    """C with C[i] = sum(x[:i])."""
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


def speedy_window_difference(reference, first_query, second_query, *,
                             window_size: int, ref_chrom_name: str,
                             remove_n: bool, long_output: bool,
                             divergence_rate: float, output_aln_pos: bool,
                             gc_content: bool, out) -> None:
    fq = np.asarray(first_query)
    sq = np.asarray(second_query)
    ref = np.asarray(reference)
    W = window_size

    if not long_output and not output_aln_pos and not gc_content:
        # the short format: the whole scan in one native call where the
        # library is built; the numpy path below is its fallback
        data = native.fa_find_windows(ref, fq, sq, W, remove_n,
                                      ref_chrom_name)
        if data is not None:
            sink = getattr(out, "buffer", None)  # text file -> raw bytes
            if sink is not None:
                sink.write(data)
            elif hasattr(out, "getbuffer"):  # BytesIO
                out.write(data)
            else:
                out.write(data.decode())
            return

    p_cache = None
    if divergence_rate != MAX_FLOAT64:
        p_cache = binomial_dist_cache_log10(W, divergence_rate)

    base_pos = np.nonzero(fq != dna.GAP)[0]  # b_k: alignment idx of k-th base
    K = len(base_pos)
    if K < W:
        return

    fqb = fq[base_pos]
    sqb = sq[base_pos]

    # per-base event vectors over k (incrementWindowEdge outputs 5,7,8,3,4)
    fq_n = (fqb == dna.N).astype(np.int64)
    sq_n_match = (sqb == dna.N).astype(np.int64)
    subst = ((fqb != sqb) & dna.define_base_mask(fqb)
             & dna.define_base_mask(sqb)).astype(np.int64)
    sq_gap = sqb == dna.GAP
    prev_sq_gap = np.concatenate(([False], sq_gap[:-1]))
    prev_exists = np.arange(K) > 0
    gap_opened2 = (sq_gap & (~prev_exists | ~prev_sq_gap)).astype(np.int64)
    gap_closed2 = (~sq_gap & prev_exists & prev_sq_gap).astype(np.int64)

    # run quantities: the firstQuery gap run strictly before b_k
    # (incrementWindowEdge outputs 2 and 6), via alignment-axis prefixes
    gap_mask = fq == dna.GAP
    c_ns_gap = _prefix((gap_mask & (sq == dna.N)).astype(np.int64))
    c_oc_gap = _prefix((gap_mask & (sq != dna.GAP)).astype(np.int64))
    run_start = np.concatenate(([0], base_pos[:-1] + 1))  # aln idx after b_{k-1}
    run_ns_gap = c_ns_gap[base_pos] - c_ns_gap[run_start]
    run_gap_oc = (c_oc_gap[base_pos] - c_oc_gap[run_start] > 0).astype(np.int64)

    # prefix sums over k
    Csub = _prefix(subst)
    Cn_base = _prefix(fq_n + sq_n_match)
    Cr_ns = _prefix(run_ns_gap)
    Cr_oc = _prefix(run_gap_oc)
    Cop = _prefix(gap_opened2)
    Ccl = _prefix(gap_closed2)

    ws = np.arange(K - W + 1)  # window start (k index of first base)
    total_subst = Csub[ws + W] - Csub[ws]
    total_ns = (Cn_base[ws + W] - Cn_base[ws]) + (Cr_ns[ws + W] - Cr_ns[ws + 1])
    total_gaps = (Cr_oc[ws + W] - Cr_oc[ws + 1]) + Cop[ws + W] - Ccl[ws + 1]

    if gc_content:
        up = dna.to_upper(fqb)
        uq = dna.to_upper(sqb)
        Cgc1 = _prefix(((up == dna.C) | (up == dna.G)).astype(np.int64))
        Cgc2 = _prefix(((uq == dna.C) | (uq == dna.G)).astype(np.int64))
        Cat1 = _prefix(((up == dna.A) | (up == dna.T)).astype(np.int64))
        Cat2 = _prefix(((uq == dna.A) | (uq == dna.T)).astype(np.int64))
        gc1 = Cgc1[ws + W] - Cgc1[ws]
        gc2 = Cgc2[ws + W] - Cgc2[ws]
        at1 = Cat1[ws + W] - Cat1[ws]
        at2 = Cat2[ws + W] - Cat2[ws]

    # coordinates: ref positions are non-gap ref counts before an aln pos
    c_ref = _prefix((ref != dna.GAP).astype(np.int64))
    first_aln = base_pos[ws]            # b_ws, alignment idx of window start
    last_aln = base_pos[ws + W - 1]     # b_{ws+W-1}
    chrom_start = c_ref[first_aln]
    chrom_end = c_ref[last_aln + 1]
    # report gate (efficient.go: reference gap at window edges skips window)
    ref_gap = ref == dna.GAP
    keep = ~(ref_gap[first_aln] | ref_gap[last_aln])
    if remove_n:
        keep &= total_ns == 0
    # outputAlnPos column: alnIdxBeforeWindow+1 = b_{ws-1}+1 (0 for ws=0)
    aln_pos_col = np.concatenate(([0], base_pos[:-1] + 1))[ws] if K else ws

    name = ref_chrom_name
    idx = np.nonzero(keep)[0]
    if not long_output and not output_aln_pos and not gc_content:
        # the short format in bulk, one Python join
        muts_v = (total_subst + total_gaps)[idx]
        out.write("".join(
            f"{name}\t{s}\t{e}\t{name}_{s}\t{m}\n"
            for s, e, m in zip(chrom_start[idx].tolist(),
                               chrom_end[idx].tolist(), muts_v.tolist())))
        return
    for i in idx:
        muts = int(total_subst[i] + total_gaps[i])
        s, e = int(chrom_start[i]), int(chrom_end[i])
        if long_output:
            if muts > W:
                raise ValueError("total number of mutations exceeds windowSize")
            pct = 100 * (muts / W)
            pval = p_cache.get(muts, 0.0) if p_cache is not None else 0.0
            if output_aln_pos:
                out.write(f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}\t+\t"
                          f"{go_fmt_e(pct)}\t{go_fmt_e(pval)}\t{int(aln_pos_col[i])}\n")
            else:
                out.write(f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}\t+\t"
                          f"{go_fmt_e(pct)}\t{go_fmt_e(pval)}\n")
        elif output_aln_pos:
            out.write(f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}\t{int(aln_pos_col[i])}\n")
        elif gc_content:
            if gc1[i] + at1[i] != W:
                raise ValueError("totalFirstQueryGCs + totalFirstQueryATs != windowSize")
            gc_frac1 = gc1[i] / (gc1[i] + at1[i])
            gc_frac2 = gc2[i] / (gc2[i] + at2[i])
            out.write(f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}\t{int(gc1[i])}\t"
                      f"{int(gc2[i])}\t{int(at1[i])}\t{int(at2[i])}\t"
                      f"{go_fmt_e(gc_frac1)}\t{go_fmt_e(gc_frac2)}\n")
        else:
            out.write(f"{name}\t{s}\t{e}\t{name}_{s}\t{muts}\n")


def fa_find_fast(in_file: str, out_file: str, *, first_query_name: str = "",
                 second_query_name: str = "", window_size: int = 1000,
                 ref_chrom_name: str = "", remove_n: bool = False,
                 long_output: bool = False,
                 divergence_rate: float = MAX_FLOAT64,
                 output_aln_pos: bool = False,
                 gc_content: bool = False) -> None:
    records = fasta.read(in_file)
    rec_map = fasta.to_map(records)
    if len(records) < 2:
        raise SystemExit("Error: There must be at least 2 fasta records in "
                         "the input file.")
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
            output_aln_pos=output_aln_pos, gc_content=gc_content, out=out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="faFindFast",
        description="Returns number of mutations that separate two sequences "
                    "for a given window size")
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
    p.add_argument("-gcContent", action="store_true")
    a = p.parse_args(argv)
    if a.longOutput and a.divergenceRate == MAX_FLOAT64:
        raise SystemExit("Error: must set a 'divergenceRate' if using the "
                         "'longOutput' option.")
    if a.divergenceRate != MAX_FLOAT64 and not (0 <= a.divergenceRate <= 1):
        raise SystemExit("Error: divergence rate must be a value between 0 "
                         "and 1.")
    if a.gcContent and (a.removeN or a.longOutput or a.outputAlnPos):
        raise SystemExit("Error: 'gcContent' currently cannot be used "
                         "together with 'removeN', 'longOutput' or "
                         "'outputAlnPos'.")
    fa_find_fast(a.input, a.output, first_query_name=a.firstQueryName,
                 second_query_name=a.secondQueryName,
                 window_size=a.windowSize, ref_chrom_name=a.chrom,
                 remove_n=a.removeN, long_output=a.longOutput,
                 divergence_rate=a.divergenceRate,
                 output_aln_pos=a.outputAlnPos, gc_content=a.gcContent)


if __name__ == "__main__":
    main()
