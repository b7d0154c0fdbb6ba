"""callVariants on the PyTorch port: the whole of
``gonomics_tpu/cli/call_variants.py`` on the port's host copies.

    python -m gonomics_tpu_torch.cli.call_variants -i exp.sam [-n norm.sam] \\
        -r ref.fa [-o out.vcf] [--mesh [--device cpu]] [--profile DIR]

A joint variant caller over experimental and normal samples (the
reference's cmd/callVariants): a pileup a file, merged by position,
Fisher's exact test on the experimental-against-background 2x2 table
with the AF, strand-bias and depth filters, multi-allelic VCF records
with deletion anchoring; byte-identical to the JAX ``callVariants``.
``--mesh`` counts the pileup on ``parallel.make_mesh()`` over every CUDA
device (one (1, 1) cell on one card; it raises without a card), or on a
mesh of one CPU device with ``--device cpu``; the VCF is the same.
``--profile DIR`` runs the call under ``torch.profiler`` and writes
DIR/call_variants.pt.trace.json.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

import numpy as np

import torch
from torch.profiler import ProfilerActivity, profile

from .. import dna, fileio
from ..io import sam as samio
from ..io import vcf as vcfio
from ..io.fai import Seeker
from ..numbers import fisher_exact
from ..pileup import Pile, calc_depth, sum_piles

SNV, INS, DEL = 0, 1, 2


def _fmt_p(p: float) -> str:
    return f"{p:.0g}"


def _fdiv(x: float, y: float) -> float:
    """Go float64 division: 0/0 = NaN, x/0 = +/-Inf (comparisons with NaN
    are false, matching the reference's exclusion-case behavior)."""
    if y != 0:
        return x / y
    if x == 0:
        return float("nan")
    return float("inf") if x > 0 else float("-inf")


def make_output_header(filenames: list[str]) -> vcfio.Header:
    sample_names = [os.path.splitext(os.path.basename(f))[0]
                    for f in filenames]
    t = datetime.date.today().strftime("%Y%m%d")
    text = [
        "##fileformat=VCFv4.2",
        f"##fileDate={t}",
        "##source=github.com/vertgenlab/gonomics",
        "##phasing=none",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Total Depth">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Depth of Each Allele">',
        '##FORMAT=<ID=PV,Number=A,Type=Float,Description="p value for Each Alternate Allele">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(sample_names),
    ]
    return vcfio.Header(text=text)


def _get_ref(start: int, end: int, chrom: str, ref: Seeker) -> np.ndarray:
    """testVariant.go getRef: base before + requested range, N-padded at
    chromosome start; uppercased."""
    seek_start = start - 1
    if seek_start == -1:
        seek_start = 0
    bases = dna.to_upper(ref.seek_by_name(chrom, seek_start, end))
    if len(bases) == 1:
        bases = np.concatenate(([np.int8(dna.N)], bases))
    return bases


def _get_possible_alts(exp: list[Pile], ref_base: int):
    """testVariant.go getPossibleAlts. Deletion keys are emitted in sorted
    numeric order and insertions in (length, lexicographic) order — the
    reference iterates Go maps (random order) but sorts insertions; its
    goldens are consistent with sorted deletion order."""
    s = sum_piles(exp)
    alts: list[str] = []
    types: list[int] = []
    for i in range(13):
        if i == ref_base or i == dna.GAP:
            continue
        if s.count_f[i] > 0 or s.count_r[i] > 0:
            alts.append(dna.to_string(np.array([i], np.int8)))
            types.append(SNV)
    del_keys = sorted(set(k for k, v in s.del_count_f.items() if v > 0)
                      | set(k for k, v in s.del_count_r.items() if v > 0))
    for k in del_keys:
        alts.append(str(k))
        types.append(DEL)
    ins_keys = set(k for k, v in s.ins_count_f.items() if v > 0) \
        | set(k for k, v in s.ins_count_r.items() if v > 0)
    for k in sorted(ins_keys, key=lambda x: (len(x), x)):
        alts.append(k)
        types.append(INS)
    return alts, types


def _fishers_exact_test(alt: str, exp: Pile, bkgd: Pile, has_norm: bool,
                        min_af, max_af, max_strand_bias, min_coverage,
                        min_alt_reads, var_type: int) -> float:
    """testVariant.go fishersExactTest, exclusion cases in order."""
    if var_type == SNV:
        code = int(dna.from_string(alt)[0])
        c = int(exp.count_f[code] + exp.count_r[code])
        d = int(bkgd.count_f[code] + bkgd.count_r[code])
        fwd = int(exp.count_f[code])
    elif var_type == INS:
        c = exp.ins_count_f.get(alt, 0) + exp.ins_count_r.get(alt, 0)
        d = bkgd.ins_count_f.get(alt, 0) + bkgd.ins_count_r.get(alt, 0)
        fwd = exp.ins_count_f.get(alt, 0)
    else:
        k = int(alt)
        c = exp.del_count_f.get(k, 0) + exp.del_count_r.get(k, 0)
        d = bkgd.del_count_f.get(k, 0) + bkgd.del_count_r.get(k, 0)
        fwd = exp.del_count_f.get(k, 0)

    fwd_strand_bias = _fdiv(fwd, c)
    if fwd_strand_bias > max_strand_bias or fwd_strand_bias < 1 - max_strand_bias:
        return 1.0

    a = calc_depth(exp) - c
    b = calc_depth(bkgd) - d
    if not has_norm:
        b -= a
        d -= c

    if c < min_alt_reads:
        return 1.0
    if a == b and c == d:
        return 1.0
    if _fdiv(c, c + a) < _fdiv(d, d + b):
        return 1.0
    if a + c < min_coverage:
        return 1.0
    if _fdiv(c, c + a) < min_af or _fdiv(c, c + a) > max_af:
        return 1.0
    return fisher_exact(a, b, c, d, True)


def _get_format_data(s: Pile, s_idx: int, ref_base: int, alts: list[str],
                     alt_pvals: list[list[float]], var_types: list[int]):
    depth = calc_depth(s)
    pvals = [0.0] * len(alts)
    counts = [int(s.count_f[ref_base] + s.count_r[ref_base])]
    for i, alt in enumerate(alts):
        if var_types[i] == SNV:
            b = int(dna.from_string(alt)[0])
            counts.append(int(s.count_f[b] + s.count_r[b]))
        elif var_types[i] == INS:
            counts.append(s.ins_count_f.get(alt, 0)
                          + s.ins_count_r.get(alt, 0))
        else:
            k = int(alt)
            counts.append(s.del_count_f.get(k, 0) + s.del_count_r.get(k, 0))
        if s_idx < len(alt_pvals[i]):
            pvals[i] = alt_pvals[i][s_idx]
    genotype = [i for i, c in enumerate(counts) if c > 0]
    if len(genotype) == 1:
        genotype.append(genotype[0])
    return genotype, depth, counts, pvals


def _sprint_ad(ad: list[int]) -> str:
    return ",".join(str(x) for x in ad)


def _sprint_pv(pv: list[float]) -> str:
    if len(pv) == 1 and pv[0] == -1:
        return "."
    return ",".join(_fmt_p(x) for x in pv)


def _adjust_alts(v: vcfio.Vcf, deletion_indexes: list[int],
                 var_types: list[int], ref: Seeker) -> vcfio.Vcf:
    """testVariant.go adjustAlts + get*AltString."""
    del_lens = [int(v.alt[i]) for i in deletion_indexes]
    longest = max(del_lens, default=0)
    has_anchor = False
    if deletion_indexes:
        v.pos -= 1
        ref_bases = _get_ref(v.pos, v.pos + longest, v.chrom, ref)
        v.ref = dna.to_string(ref_bases)
        has_anchor = True
    del_len_idx = 0
    for i in range(len(v.alt)):
        if var_types[i] == SNV:
            s = (v.ref[0] if has_anchor else "") + v.alt[i][0]
            if len(v.ref) > 2:
                s += v.ref[2:]
            v.alt[i] = s
        elif var_types[i] == INS:
            if not has_anchor:
                v.alt[i] = v.ref + v.alt[i]
            else:
                s = v.ref[:2] + v.alt[i]
                if len(v.ref) > 2:
                    s += v.ref[2:]
                v.alt[i] = s
        else:
            d = del_lens[del_len_idx]
            del_len_idx += 1
            s = v.ref[0]
            if len(v.ref) > d + 1:
                s += v.ref[d + 1:]
            v.alt[i] = s
    return v


def get_variant(exp: list[Pile], norm: list[Pile], header: samio.Header,
                ref: Seeker, max_p, min_af, max_af, max_strand_bias,
                min_coverage, min_alt_reads):
    """testVariant.go getVariant."""
    warnings: list[str] = []
    if not any(p.ref_idx != -1 for p in exp):
        return None
    if not any(p.ref_idx != -1 for p in norm):
        bkgd = sum_piles(exp)
        warnings.append("NO_NORMAL")
        has_norm = False
    else:
        bkgd = sum_piles(norm)
        has_norm = True

    chrom = header.chroms[bkgd.ref_idx].name
    ref_bases = _get_ref(int(bkgd.pos) - 1, int(bkgd.pos), chrom, ref)

    possible_alts, var_types = _get_possible_alts(exp, int(ref_bases[1]))
    alt_pvals = []
    for i, alt in enumerate(possible_alts):
        row = []
        for e in exp:
            if e.ref_idx == -1:
                row.append(1.0)
            else:
                row.append(_fishers_exact_test(
                    alt, e, bkgd, has_norm, min_af, max_af, max_strand_bias,
                    min_coverage, min_alt_reads, var_types[i]))
        alt_pvals.append(row)

    # getPassingAlts
    alts, pvals, types = [], [], []
    for i in range(len(possible_alts)):
        if any(p < max_p for p in alt_pvals[i]):
            alts.append(possible_alts[i])
            pvals.append(alt_pvals[i])
            types.append(var_types[i])
    if not alts:
        return None

    # makeVcf
    v = vcfio.Vcf(chrom=chrom, pos=int(bkgd.pos), id=".",
                  filter=";".join(warnings), info=".",
                  format=["GT", "DP", "AD", "PV"])
    v.samples = [vcfio.Sample() for _ in range(len(exp) + len(norm))]
    all_samples = exp + norm
    for i, s in enumerate(all_samples):
        genotype, depth, counts, pv = _get_format_data(
            s, i, int(ref_bases[1]), alts, pvals, types)
        if i >= len(exp):
            pv = [-1]
        v.samples[i].alleles = genotype if genotype else None
        v.samples[i].phase = [False] * len(genotype)
        v.samples[i].format_data = ["", str(depth), _sprint_ad(counts),
                                    _sprint_pv(pv)]
    v.ref = dna.to_string(ref_bases[1:2])
    v.alt = list(alts)
    deletion_indexes = [i for i, t in enumerate(types) if t == DEL]
    return _adjust_alts(v, deletion_indexes, types, ref)


def _gather_counts(cd, idx: np.ndarray, lo: int) -> np.ndarray:
    """(C, 13, 2) int64 counts at candidate offsets idx (rel to lo) for one
    sample's _ChromCounts, zeros outside its covered span."""
    out = np.zeros((len(idx), 13, 2), np.int64)
    if cd is None:
        return out
    rel = idx + lo - cd.lo
    m = (rel >= 0) & (rel < cd.counts.shape[0])
    out[m] = cd.counts[rel[m]]
    return out


def _fisher_exact_less_vec(a, b, c, d) -> np.ndarray:
    """Vectorized one-sided Fisher (numbers.FisherExact, aSmall=True).

    The initial hypergeometric term uses a log-factorial table (~1e-14
    relative accuracy vs the scalar carefulMultDivFloat path); the tail
    recurrence is the scalar loop's exact float64 recurrence. Callers
    compare against max_p with a small safety margin and confirm passes
    through the exact scalar path, so last-ulp differences cannot change
    output (see call_variants)."""
    a = a.astype(np.int64).copy()
    b = b.astype(np.int64).copy()
    c = c.astype(np.int64).copy()
    d = d.astype(np.int64).copy()
    n = a + b + c + d
    if len(n) == 0:
        return np.zeros(0)
    lf = np.concatenate(([0.0], np.cumsum(np.log(
        np.arange(1, int(n.max()) + 1, dtype=np.float64)))))
    curr = np.exp(lf[a + b] + lf[c + d] + lf[a + c] + lf[b + d]
                  - lf[n] - lf[a] - lf[b] - lf[c] - lf[d])
    total = curr.copy()
    active = (a > 0) & (d > 0)
    while active.any():
        a[active] -= 1
        b[active] += 1
        c[active] += 1
        d[active] -= 1
        curr[active] *= ((a[active] + 1).astype(np.float64) / c[active]
                         * (d[active] + 1).astype(np.float64) / b[active])
        total[active] += curr[active]
        active &= (a > 0) & (d > 0)
    return total


def _vector_snv_pass(cds, exists, depths, expsum, ref_codes, vec_idx,
                     lo, n_exp, max_p, min_af, max_af, max_strand_bias,
                     min_coverage, min_alt_reads) -> np.ndarray:
    """One vectorized pass of getVariant's SNV decision over candidate
    sites with no indel evidence: replicates fishersExactTest's exclusion
    cascade (testVariant.go:307-388) in exact integer arithmetic and the
    Fisher tail in float64, returning which sites have ANY alt passing
    p < max_p for ANY experimental sample. Passing sites re-run the exact
    scalar getVariant, so this pass only needs to be no-miss."""
    n_samp = len(cds)
    idx = vec_idx
    C = len(idx)
    ex_c = exists[:, idx]
    dep_c = depths[:, idx]
    G = [_gather_counts(cds[i], idx, lo) for i in range(n_samp)]
    has_norm = (ex_c[n_exp:].any(axis=0) if n_samp > n_exp
                else np.zeros(C, bool))
    B_norm = np.zeros((C, 13, 2), np.int64)
    dep_norm = np.zeros(C, np.int64)
    for i in range(n_exp, n_samp):
        B_norm += G[i] * ex_c[i][:, None, None]
        dep_norm += dep_c[i] * ex_c[i]
    B_exp = np.zeros((C, 13, 2), np.int64)
    dep_exp_sum = np.zeros(C, np.int64)
    for i in range(n_exp):
        B_exp += G[i] * ex_c[i][:, None, None]
        dep_exp_sum += dep_c[i] * ex_c[i]
    B_cnt = np.where(has_norm[:, None, None], B_norm, B_exp)
    dep_b = np.where(has_norm, dep_norm, dep_exp_sum)

    # possible SNV alts: exp-sum evidence, not the ref base, not Gap
    possible = expsum[idx] > 0
    possible[np.arange(C), np.clip(ref_codes[idx], 0, 12)] = False
    possible[:, dna.GAP] = False

    d_all = B_cnt[:, :, 0] + B_cnt[:, :, 1]  # (C, 13)
    site_pass = np.zeros(C, bool)
    if 1.0 < max_p:
        # exclusion cases and non-existing samples yield p == 1.0, which
        # itself passes: any site with a possible alt emits
        return possible.any(axis=1)
    for e in range(n_exp):
        c = G[e][:, :, 0] + G[e][:, :, 1]
        fwd = G[e][:, :, 0]
        mask = possible & ex_c[e][:, None]
        dep_e = dep_c[e][:, None]
        a = dep_e - c
        b = dep_b[:, None] - d_all
        d = d_all.copy()
        nh = ~has_norm
        b[nh] -= a[nh]
        d[nh] -= c[nh]
        with np.errstate(divide="ignore", invalid="ignore"):
            fsb = fwd / c.astype(np.float64)
            mask &= ~((fsb > max_strand_bias) | (fsb < 1 - max_strand_bias))
            mask &= ~(c < min_alt_reads)
            mask &= ~((a == b) & (c == d))
            rc = c / (c + a).astype(np.float64)
            rd = d / (d + b).astype(np.float64)
            mask &= ~(rc < rd)
            mask &= ~(a + c < min_coverage)
            mask &= ~((rc < min_af) | (rc > max_af))
        if mask.any():
            si, ai = np.nonzero(mask)
            p = _fisher_exact_less_vec(a[si, ai], b[si, ai],
                                       c[si, ai], d[si, ai])
            site_pass[si[p < max_p * (1 + 1e-9)]] = True
    return site_pass


class _CachedSeeker(Seeker):
    """Seeker that loads each chromosome once and serves slices from
    memory — getVariant asks for one anchor base per site, which would
    otherwise cost a file seek per site."""

    def __init__(self, fasta_path: str, index_path: str = ""):
        super().__init__(fasta_path, index_path)
        self._cache: dict[str, np.ndarray] = {}

    def chrom_array(self, chrom: str) -> np.ndarray:
        arr = self._cache.get(chrom)
        if arr is None:
            arr = super().seek_by_name(chrom, 0, self.by_name[chrom].length)
            self._cache[chrom] = arr
        return arr

    def seek_by_name(self, chrom: str, start: int, end: int) -> np.ndarray:
        if start > end or start < 0:
            raise ValueError("bad seek range")
        return self.chrom_array(chrom)[start:min(end,
                                                 self.by_name[chrom].length)]


def call_variants(experimental_files: list[str], normal_files: list[str],
                  ref_file: str, out_file: str, max_p=0.001, min_af=0.01,
                  max_af=1.0, max_strand_bias=0.9, min_coverage=10,
                  min_mapq=10, min_alt_reads=1, mesh=None) -> None:
    """Joint caller (callVariants.go:40-127) with a vectorized candidate
    prescreen: the dense per-chromosome count tensors (pileup_dense)
    yield, in one pass, the sites where getVariant could possibly emit —
    exp data present AND (a non-ref/non-gap base count, or indel
    evidence) — exactly the condition for getPossibleAlts to be
    non-empty (testVariant.go:166-285). Only those sites materialize
    Pile objects and run the exact per-site caller, so output is
    byte-identical to the site-by-site loop."""
    from .. import native
    from ..pileup import (pile_from_dense, pileup_dense,
                          pileup_dense_from_sam_path)

    out = fileio.easy_create(out_file)
    vcfio.new_write_header(
        out, make_output_header(experimental_files + normal_files))

    read_filters = [lambda s: s.mapq >= min_mapq]

    # when several files load concurrently, each native scatter runs
    # single-threaded (one core per file) — oversubscribing threads
    # inside a saturated pool SLOWED the 2-file load ~2x
    nt = 1 if len(experimental_files) + len(normal_files) > 1 else 0

    def load_one(fn: str):
        if native.available() and not samio._is_bam(fn):
            header = samio.read_header_text(fn)
            if not header.text:
                raise SystemExit("ERROR: sam/bam files must have headers")
            return header, pileup_dense_from_sam_path(fn, header, min_mapq,
                                                      mesh=mesh,
                                                      nthreads=nt)
        header, reads = samio.read(fn)
        if not header.text:
            raise SystemExit("ERROR: sam/bam files must have headers")
        return header, pileup_dense(reads, header, read_filters, mesh=mesh)

    files = experimental_files + normal_files
    if mesh is None and len(files) > 1 and native.available():
        # per-file loads run concurrently: the native parse/scatter calls
        # release the GIL (goroutine-per-sample in callVariants.go:47-60)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(4, len(files))) as ex:
            loaded = list(ex.map(load_one, files))
    else:
        loaded = [load_one(fn) for fn in files]
    headers = [h for h, _ in loaded]
    dense = [d for _, d in loaded]

    ref_chroms = headers[0].chroms
    for h in headers[1:]:
        if h.chroms != ref_chroms:
            raise SystemExit("ERROR: reference chromosomes in input files "
                             "must match and be in the same order")

    n_exp = len(experimental_files)
    n_samp = len(dense)
    ref = _CachedSeeker(ref_file)
    t0 = time.perf_counter()
    n_sites = n_vars = 0
    all_refidx = sorted(set().union(*[set(d) for d in dense]))
    for refidx in all_refidx:
        chrom = headers[0].chroms[refidx].name
        cds = [d.get(refidx) for d in dense]
        lo = min(cd.lo for cd in cds if cd is not None)
        hi = max(cd.lo + cd.counts.shape[0] for cd in cds if cd is not None)
        for cd in cds:
            if cd is not None:
                hi = max(hi, max(cd.ins.keys(), default=hi - 1) + 1)
        L = hi - lo
        if native.available() and all(cd is None or cd.cnt2 is not None
                                      for cd in cds):
            # the whole prescreen (exists/depth/expsum/cand) in one
            # threaded C pass over the dense arrays the scatter already
            # produced; semantics mirror the numpy body below exactly
            cnt2_list, depth_list, offs, spans = [], [], [], []
            ins_pos_l: list[int] = []
            ins_tot_l: list[int] = []
            ins_off = [0]
            del_pos_l: list[int] = []
            del_off = [0]
            for cd in cds:
                if cd is None:
                    cnt2_list.append(np.zeros((0, 13), np.int32))
                    depth_list.append(np.zeros(0, np.int32))
                    offs.append(0)
                    spans.append(0)
                else:
                    cnt2_list.append(cd.cnt2)
                    depth_list.append(cd.depth_arr)
                    offs.append(cd.lo - lo)
                    spans.append(cd.cnt2.shape[0])
                    for p, (mf, mr) in cd.ins.items():
                        ins_pos_l.append(p)
                        ins_tot_l.append(sum(mf.values())
                                         + sum(mr.values()))
                    for p in cd.dels:
                        del_pos_l.append(p)
                ins_off.append(len(ins_pos_l))
                del_off.append(len(del_pos_l))
            raw_ref = ref.chrom_array(chrom)
            exists, depths, expsum, cand, indel_pos, ns = \
                native.cv_prescreen(cnt2_list, depth_list, offs, spans,
                                    ins_pos_l, ins_tot_l, ins_off,
                                    del_pos_l, del_off, n_exp, L, lo,
                                    raw_ref, min_coverage)
            n_sites += ns
            refarr = dna.to_upper(raw_ref)
            pos_idx = np.arange(lo, hi)
            ref_codes = np.full(L, dna.N, np.int64)
            valid_pos = (pos_idx >= 1) & (pos_idx <= len(refarr))
            ref_codes[valid_pos] = refarr[pos_idx[valid_pos] - 1]
            vec_mask = cand & ~indel_pos
            emit = np.nonzero(cand & indel_pos)[0].tolist()
            vec_idx = np.nonzero(vec_mask)[0]
            if len(vec_idx):
                passed = None
                if max_p <= 1.0:
                    # SNV cascade + Fisher tail in one threaded C pass
                    passed = native.cv_snv_pass(
                        [None if cd is None else cd.counts for cd in cds],
                        [0 if cd is None else cd.lo - lo for cd in cds],
                        [0 if cd is None else cd.counts.shape[0]
                         for cd in cds],
                        exists, depths, expsum,
                        ref_codes.astype(np.int8), vec_idx, n_exp,
                        max_p, min_af, max_af, max_strand_bias,
                        min_coverage, min_alt_reads)
                if passed is None:
                    passed = _vector_snv_pass(
                        cds, exists, depths, expsum, ref_codes, vec_idx,
                        lo, n_exp, max_p, min_af, max_af,
                        max_strand_bias, min_coverage, min_alt_reads)
                emit.extend(vec_idx[passed].tolist())
            for p_off in sorted(emit):
                pos = lo + p_off
                piles = []
                for i, cd in enumerate(cds):
                    if cd is not None and exists[i, p_off]:
                        piles.append(pile_from_dense(cd, refidx, pos))
                    else:
                        piles.append(Pile(ref_idx=-1))
                v = get_variant(piles[:n_exp], piles[n_exp:], headers[0],
                                ref, max_p, min_af, max_af,
                                max_strand_bias, min_coverage,
                                min_alt_reads)
                if v is not None:
                    n_vars += 1
                    vcfio.write_vcf(out, v)
            continue
        exists = np.zeros((n_samp, L), bool)
        depths = np.zeros((n_samp, L), np.int64)
        expsum = np.zeros((L, 13), np.int32)
        indel_ev = np.zeros(L, bool)
        indel_pos = np.zeros(L, bool)
        for i, cd in enumerate(cds):
            if cd is None:
                continue
            span = cd.counts.shape[0]
            off = cd.lo - lo
            if cd.cnt2 is not None:
                cnt = cd.cnt2
                depth = cd.depth_arr.astype(np.int64)
            else:
                cnt = cd.counts.sum(axis=2)  # (span, 13)
                depth = cnt.sum(axis=1).astype(np.int64)
            touched = depth > 0  # counts are non-negative
            dvec = np.zeros(L, np.int64)
            tvec = np.zeros(L, bool)
            dvec[off:off + span] = depth
            tvec[off:off + span] = touched
            for p, (mf, mr) in cd.ins.items():
                dvec[p - lo] += sum(mf.values()) + sum(mr.values())
                tvec[p - lo] = True
                indel_pos[p - lo] = True
            for p in cd.dels:
                if 0 <= p - lo < L:
                    indel_pos[p - lo] = True
            exists[i] = tvec & (dvec >= min_coverage)
            depths[i] = dvec
            if i < n_exp:
                expsum[off:off + span] += (
                    cnt * exists[i][off:off + span, None])
                for p, (mf, mr) in cd.ins.items():
                    if exists[i, p - lo] and (any(v > 0 for v in mf.values())
                                              or any(v > 0
                                                     for v in mr.values())):
                        indel_ev[p - lo] = True
                for p, (mf, mr) in cd.dels.items():
                    if p - lo >= 0 and p - lo < L and exists[i, p - lo] and \
                            (any(v > 0 for v in mf.values())
                             or any(v > 0 for v in mr.values())):
                        indel_ev[p - lo] = True
        union = exists.any(axis=0)
        n_sites += int(union.sum())
        exp_any = exists[:n_exp].any(axis=0)
        # zero out the ref and Gap columns: what remains is exactly
        # getPossibleAlts' SNV evidence
        refarr = dna.to_upper(ref.chrom_array(chrom))
        pos_idx = np.arange(lo, hi)
        ref_codes = np.full(L, dna.N, np.int64)
        valid_pos = (pos_idx >= 1) & (pos_idx <= len(refarr))
        ref_codes[valid_pos] = refarr[pos_idx[valid_pos] - 1]
        # SNV evidence = row total minus the ref-base and Gap columns
        # (exactly getPossibleAlts' non-empty condition)
        clip_codes = np.clip(ref_codes, 0, 12)
        snv_ev = (expsum.sum(axis=1)
                  - expsum[np.arange(L), clip_codes]
                  - expsum[:, dna.GAP] * (clip_codes != dna.GAP))
        cand = exp_any & ((snv_ev > 0) | indel_ev)
        # pure-SNV candidate sites go through one vectorized decision
        # pass; only the passing ones (plus any site with indel
        # evidence) materialize Piles and run the exact scalar caller
        vec_mask = cand & ~indel_pos
        emit = np.nonzero(cand & indel_pos)[0].tolist()
        vec_idx = np.nonzero(vec_mask)[0]
        if len(vec_idx):
            passed = _vector_snv_pass(
                cds, exists, depths, expsum, ref_codes, vec_idx, lo,
                n_exp, max_p, min_af, max_af, max_strand_bias,
                min_coverage, min_alt_reads)
            emit.extend(vec_idx[passed].tolist())
        for p_off in sorted(emit):
            pos = lo + p_off
            piles = []
            for i, cd in enumerate(cds):
                if cd is not None and exists[i, p_off]:
                    piles.append(pile_from_dense(cd, refidx, pos))
                else:
                    piles.append(Pile(ref_idx=-1))
            v = get_variant(piles[:n_exp], piles[n_exp:], headers[0], ref,
                            max_p, min_af, max_af, max_strand_bias,
                            min_coverage, min_alt_reads)
            if v is not None:
                n_vars += 1
                vcfio.write_vcf(out, v)
    ref.close()
    # per-stage summary like the reference's pipeline timing lines
    # (cmd/gsw/pairedEndFastqs.go:69-72)
    dt = max(time.perf_counter() - t0, 1e-9)
    print(f"callVariants: {n_sites} sites tested, {n_vars} variants "
          f"in {dt:.1f}s ({n_sites / dt:.0f} sites/s)", file=sys.stderr)
    if out_file not in ("-", "stdout"):
        out.close()


def make_mesh_for(device: str):
    """``--mesh``'s mesh: every CUDA device (``parallel.make_mesh()``,
    which raises without one), or one CPU device where ``device`` is
    "cpu"."""
    from ..parallel import make_mesh

    if device == "cpu":
        return make_mesh(devices=["cpu"], data=1)
    return make_mesh()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="callVariants")
    p.add_argument("-i", action="append", default=[], dest="exp",
                   help="Input experimental files (.bam, .sam)")
    p.add_argument("-n", action="append", default=[], dest="norm",
                   help="Input normal files (.bam, .sam)")
    p.add_argument("-p", type=float, default=0.001)
    p.add_argument("-minAF", type=float, default=0.01)
    p.add_argument("-maxAF", type=float, default=1.0)
    p.add_argument("-maxStrandBias", type=float, default=0.9)
    p.add_argument("-minCoverage", type=int, default=10)
    p.add_argument("-minMapQ", type=int, default=10)
    p.add_argument("-minAltReads", type=int, default=1)
    p.add_argument("-r", required=True, help="Indexed reference fasta")
    p.add_argument("-o", default="stdout")
    p.add_argument("--mesh", action="store_true",
                   help="count the pileup on a data x seq mesh of every "
                        "CUDA device (summed over data)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="with --mesh: cpu gives a mesh of one CPU device")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace to this directory")
    a = p.parse_args(argv)
    if not a.exp:
        raise SystemExit("ERROR: must declare at least 1 experimental "
                         "sample with -i")
    mesh = make_mesh_for(a.device) if a.mesh else None

    def run():
        call_variants(a.exp, a.norm, a.r, "-" if a.o == "stdout" else a.o,
                      a.p, a.minAF, a.maxAF, a.maxStrandBias,
                      a.minCoverage, a.minMapQ, a.minAltReads, mesh=mesh)

    if a.profile:
        on_card = mesh is not None and a.device != "cpu"
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            run()
            if on_card:
                torch.cuda.synchronize()
        os.makedirs(a.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(a.profile,
                                              "call_variants.pt.trace.json"))
    else:
        run()


if __name__ == "__main__":
    main()
