"""ctypes bindings to the repository's host runtime ``native/seqio.cpp``,
for the helpers the read aligners, the BAM reader and writer, the
variant caller and faFindFast call (mirrors the matching entries of
``gonomics_tpu/native.py``).

The shared source is compiled with ``g++`` into this package's own
``_build/`` directory on first use. These are host helpers, not device
kernels: each returns None when the library cannot be built (the first
attempt warns with the compiler's output), and its caller then takes
its numpy fallback, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

import numpy as np

from ._buildlib import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "native", "seqio.cpp")
_lock = threading.Lock()
_lib = None
_tried = False

_vp = ctypes.c_void_p
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64

# (restype, argtypes) of each entry point, as native/seqio.cpp declares it
_SIGNATURES = {
    "fastq_parse": (_i64, [ctypes.c_char_p, _i64, _i32, _i32,
                           _vp, _vp, _vp, _vp, _i64]),
    "walk_to_cigars": (_i64, [_vp, _i64, _i64, _i64, _vp, _vp, _vp, _vp,
                              _vp, _vp, _vp, _vp, _i64, _i32]),
    "seed_vote": (None, [_vp, _vp, _i64, _i64, _vp, _i32, _i32, _vp, _vp,
                         _i64, _i32, _vp, _vp, _vp, _vp, _i32]),
    "sparse_index_build": (_i64, [_vp, _i64, _i32, _i32, _i32,
                                  _vp, _vp, _vp, _i32]),
    "sparse_seed_vote": (None, [_vp, _vp, _i64, _i64, _i32, _vp, _i64,
                                _vp, _vp, _vp, _i32, _i32,
                                _vp, _vp, _vp, _vp, _i32]),
    "format_sam_lines": (_i64, [ctypes.c_char_p, _i64,   # qnames
                                ctypes.c_char_p, _i64,   # names
                                _vp, _vp,                # flags, rsel
                                _vp, _vp,                # poss, mapqs
                                _vp, _vp,                # scores, has_as
                                _vp, _vp,                # seqs, quals
                                _vp, _i32,               # lens, L
                                _vp, _vp,                # cig_off, cig_cnt
                                _vp, _vp,                # run_lens, run_ops
                                _i64, _vp, _i64]),
    "graph_hits": (_i64, [_vp, _i64, _i64, _vp, _i32, _vp, _i64, _vp, _vp,
                          _vp, _vp, _vp, _vp, _vp, _i64, _i32]),
    "fa_find_windows": (_i64, [_vp, _vp, _vp, _i64, _i32, _i32,
                               ctypes.c_char_p, _vp, _i64, _i32]),
    "bgzf_scan": (_i64, [ctypes.c_char_p, _i64]),
    "bgzf_decompress": (ctypes.c_int, [ctypes.c_char_p, _i64, _vp, _i64,
                                       ctypes.c_int]),
    "compress_blocks": (_i64, [ctypes.c_char_p, _i64, _vp, _i64, _i32, _i32,
                               _i32]),
    "sam_scatter": (ctypes.c_int, [ctypes.c_char_p, _i64,
                                   ctypes.c_char_p, _i64, _i32,
                                   _vp, _vp, _vp, _vp, _i64,   # runs
                                   _vp, _i64,                  # bases
                                   _vp, _i64,                  # deletions
                                   _vp, _i64,                  # insertions
                                   _vp, _i64,                  # ins_str
                                   _vp]),                      # counts
    "runs_to_counts": (_i32, [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i64,
                              _i64, _vp, _vp, _vp, _vp, _i32]),
    "cv_prescreen": (_i64, [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            _i32, _i32, _i64, _i64, _vp, _i64, _i32,
                            _vp, _vp, _vp, _vp, _vp, _i32]),
    "cv_snv_pass": (_i64, [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                           _i64, _i64, _i64, _i32, _i32,
                           ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double,
                           _i32, _i32, _i32, _vp, _i32]),
}


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = build_shared("libseqio.so", [_SRC],
                              ["g++", "-O2", "-shared", "-fPIC"],
                              libs=("-lz", "-pthread"))
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            warnings.warn("gonomics_tpu_torch.native: host library not "
                          "built, numpy fallbacks in use:\n" + detail,
                          RuntimeWarning, stacklevel=3)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else min(4, os.cpu_count() or 1)


def fastq_parse_batch(data: bytes, max_records: int, max_len: int):
    """Parse FASTQ text to packed (names, seq_codes, quals, lengths);
    None on fallback."""
    lib = _load()
    if lib is None:
        return None
    seq = np.empty((max_records, max_len), np.int8)
    qual = np.empty((max_records, max_len), np.uint8)
    lens = np.empty(max_records, np.int32)
    name_cap = len(data)
    names = np.empty(name_cap, np.uint8)
    n = lib.fastq_parse(data, len(data), max_records, max_len,
                        seq.ctypes.data_as(_vp), qual.ctypes.data_as(_vp),
                        lens.ctypes.data_as(_vp), names.ctypes.data_as(_vp),
                        name_cap)
    if n < 0:
        return None
    n = int(n)
    name_list = [s.decode() for s in names.tobytes().split(b"\n")[:n]]
    return name_list, seq[:n], qual[:n], lens[:n]


def format_sam_lines(qnames: str, names: list[str], flags, rsel, poss,
                     mapqs, scores, has_as, seqs, quals, lens,
                     cig_off, cig_cnt, run_lens, run_ops) -> str | None:
    """Bulk-format SAM text lines; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    qn = qnames.encode()
    nm = "\n".join(names).encode()
    B, L = seqs.shape

    def a(x, dt):
        return np.ascontiguousarray(x, dt)

    arrs = [a(flags, np.int32), a(rsel, np.int32), a(poss, np.int32),
            a(mapqs, np.int32), a(scores, np.int64), a(has_as, np.uint8),
            a(seqs, np.int8), a(quals, np.uint8), a(lens, np.int32)]
    cig = [a(cig_off, np.int32), a(cig_cnt, np.int32),
           a(run_lens, np.int32), a(run_ops, np.uint8)]
    cap = int(len(qn) + B * (2 * L + 80) + 12 * (len(cig[2]) + 1) + 1024)
    buf = ctypes.create_string_buffer(cap)
    wrote = lib.format_sam_lines(
        qn, len(qn), nm, len(nm),
        *[x.ctypes.data_as(_vp) for x in arrs], L,
        *[x.ctypes.data_as(_vp) for x in cig], B, buf, cap)
    if wrote < 0:
        return None
    return ctypes.string_at(buf, int(wrote)).decode()


def fa_find_windows(ref, fq, sq, window: int, remove_n: bool,
                    name: str, nthreads: int = 0) -> bytes | None:
    """faFindFast's whole short-format scan in one threaded C pass (the
    event pass, the window sweep with O(1) edge updates, the bed lines),
    as ASCII bytes; None without the library (native.py:571-595)."""
    lib = _load()
    if lib is None:
        return None
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    ref = np.ascontiguousarray(ref, np.int8)
    fq = np.ascontiguousarray(fq, np.int8)
    sq = np.ascontiguousarray(sq, np.int8)
    n = len(fq)
    cap = max(1024, (2 * len(name.encode()) + 48) * max(1, n - window + 1))
    buf = np.empty(cap, np.uint8)  # C writes the span it uses
    wrote = lib.fa_find_windows(
        ref.ctypes.data_as(_vp), fq.ctypes.data_as(_vp),
        sq.ctypes.data_as(_vp), n, window, 1 if remove_n else 0,
        name.encode(), buf.ctypes.data_as(_vp), cap, nthreads)
    if wrote < 0:
        return None
    return buf[:int(wrote)].tobytes()


def walk_to_cigars(packed, D: int, i0, i_end, lens, mapped,
                   nthreads: int = 0):
    """Packed walk ops -> forward flat cigar runs + soft clips for the
    whole batch. Returns (cig_off, cig_cnt, run_lens, run_ops, mapped)
    or None."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    B, P = packed.shape
    i0 = np.ascontiguousarray(i0, np.int32)
    i_end = np.ascontiguousarray(i_end, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    mp = np.ascontiguousarray(mapped, np.uint8).copy()
    cig_off = np.empty(B, np.int32)
    cig_cnt = np.empty(B, np.int32)
    cap = B * (D + 4)
    run_lens = np.empty(cap, np.int32)
    run_ops = np.empty(cap, np.uint8)
    total = lib.walk_to_cigars(
        packed.ctypes.data_as(_vp), B, P, D,
        i0.ctypes.data_as(_vp), i_end.ctypes.data_as(_vp),
        lens.ctypes.data_as(_vp), mp.ctypes.data_as(_vp),
        cig_off.ctypes.data_as(_vp), cig_cnt.ctypes.data_as(_vp),
        run_lens.ctypes.data_as(_vp), run_ops.ctypes.data_as(_vp),
        cap, _threads(nthreads))
    if total < 0:
        return None
    t = int(total)
    return cig_off, cig_cnt, run_lens[:t], run_ops[:t], mp.view(bool)


def seed_vote(fwd, rev, offs, k: int, table_codes, table_pos,
              max_hits: int, nthreads: int = 0):
    """Seed lookup + modal-diagonal voting for a whole batch in one
    threaded pass. Returns (diag, votes, second, strand) or None."""
    lib = _load()
    if lib is None:
        return None
    fwd = np.ascontiguousarray(fwd, np.int8)
    rev = np.ascontiguousarray(rev, np.int8)
    offs = np.ascontiguousarray(offs, np.int32)
    codes = np.ascontiguousarray(table_codes, np.uint64)
    tpos = np.ascontiguousarray(table_pos, np.int32)
    B, L = fwd.shape
    diag = np.empty(B, np.int64)
    votes = np.empty(B, np.int64)
    second = np.empty(B, np.int64)
    strand = np.empty(B, np.uint8)
    lib.seed_vote(fwd.ctypes.data_as(_vp), rev.ctypes.data_as(_vp), B, L,
                  offs.ctypes.data_as(_vp), len(offs), k,
                  codes.ctypes.data_as(_vp), tpos.ctypes.data_as(_vp),
                  len(codes), max_hits,
                  diag.ctypes.data_as(_vp), votes.ctypes.data_as(_vp),
                  second.ctypes.data_as(_vp), strand.ctypes.data_as(_vp),
                  _threads(nthreads))
    return diag, votes, second, strand.view(bool)


def sparse_index_build(genome: np.ndarray, k: int, step: int, BB: int,
                       nthreads: int = 0):
    """Two-level sparse seed index: step-sampled positions sorted by
    k-mer code within 2^BB top-bit buckets, plus a uint16 code-remainder
    column. Returns (pos int32, rem uint16, bucket_off int64) or None."""
    lib = _load()
    if lib is None:
        return None
    genome = np.ascontiguousarray(genome, np.int8)
    n = len(genome)
    n_pos = (n - k) // step + 1 if n >= k else 0
    pos = np.zeros(max(1, n_pos), np.int32)
    rem = np.zeros(max(1, n_pos), np.uint16)
    boff = np.zeros((1 << BB) + 1, np.int64)
    total = lib.sparse_index_build(
        genome.ctypes.data_as(_vp), n, k, step, BB,
        pos.ctypes.data_as(_vp), rem.ctypes.data_as(_vp),
        boff.ctypes.data_as(_vp), _threads(nthreads))
    return pos[:total], rem[:total], boff


def sparse_seed_vote(fwd, rev, k: int, genome, pos, rem, bucket_off,
                     BB: int, max_hits: int, nthreads: int = 0):
    """Seed lookup + modal-diagonal voting against the sparse index.
    Returns (diag, votes, second, strand) or None."""
    lib = _load()
    if lib is None:
        return None
    fwd = np.ascontiguousarray(fwd, np.int8)
    rev = np.ascontiguousarray(rev, np.int8)
    genome = np.ascontiguousarray(genome, np.int8)
    B, L = fwd.shape
    diag = np.empty(B, np.int64)
    votes = np.empty(B, np.int64)
    second = np.empty(B, np.int64)
    strand = np.empty(B, np.uint8)
    lib.sparse_seed_vote(
        fwd.ctypes.data_as(_vp), rev.ctypes.data_as(_vp), B, L, k,
        genome.ctypes.data_as(_vp), len(genome),
        pos.ctypes.data_as(_vp), rem.ctypes.data_as(_vp),
        bucket_off.ctypes.data_as(_vp), BB, max_hits,
        diag.ctypes.data_as(_vp), votes.ctypes.data_as(_vp),
        second.ctypes.data_as(_vp), strand.ctypes.data_as(_vp),
        _threads(nthreads))
    return diag, votes, second, strand.view(bool)


def graph_hits(seq2: np.ndarray, row_len: np.ndarray, k: int,
               codes: np.ndarray, packed: np.ndarray, concat: np.ndarray,
               noff: np.ndarray, nlen: np.ndarray, has_next: np.ndarray,
               prev_cnt: np.ndarray, nthreads: int = 0):
    """The graph seed finder's hits in one threaded pass: rolling k-mer
    codes of every row of seq2, binary search in the sorted (codes,
    packed) table, maximal exact-run extents within the node and the
    node-crossing flags. Returns an (H, 8) int64 array (row, rs, node,
    rs0, np0, right_run, cross_right, maybe_left) in row-major probe
    order, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    seq2 = np.ascontiguousarray(seq2, np.int8)
    row_len = np.ascontiguousarray(row_len, np.int32)
    codes = np.ascontiguousarray(codes, np.uint64)
    packed = np.ascontiguousarray(packed, np.int64)
    concat = np.ascontiguousarray(concat, np.int8)
    noff = np.ascontiguousarray(noff, np.int64)
    nlen = np.ascontiguousarray(nlen, np.int64)
    has_next = np.ascontiguousarray(has_next, np.uint8)
    prev_cnt = np.ascontiguousarray(prev_cnt, np.int32)
    R2, Lmax = seq2.shape
    cap = max(1024, 64 * R2)
    while True:
        out = np.empty((cap, 8), np.int64)
        total = lib.graph_hits(
            seq2.ctypes.data_as(_vp), R2, Lmax, row_len.ctypes.data_as(_vp),
            k, codes.ctypes.data_as(_vp), len(codes),
            packed.ctypes.data_as(_vp), concat.ctypes.data_as(_vp),
            noff.ctypes.data_as(_vp), nlen.ctypes.data_as(_vp),
            has_next.ctypes.data_as(_vp), prev_cnt.ctypes.data_as(_vp),
            out.ctypes.data_as(_vp), cap, _threads(nthreads))
        if total <= cap:
            return out[:total]
        cap = int(total)  # the pass counted every hit: a second one fits


def bgzf_decompress(data: bytes, nthreads: int | None = None) -> bytes | None:
    """BGZF decompression over threads; None where data is not BGZF or
    the library is unavailable (the caller then uses gzip)."""
    lib = _load()
    if lib is None:
        return None
    if nthreads is None:
        nthreads = os.cpu_count() or 2
    total = lib.bgzf_scan(data, len(data))
    if total < 0:
        return None
    out = np.empty(total, np.uint8)
    if lib.bgzf_decompress(data, len(data), out.ctypes.data_as(_vp), total,
                           nthreads) != 0:
        return None
    return out.tobytes()


def compress_blocks(data: bytes, *, bgzf: bool, level: int = 6,
                    nthreads: int | None = None) -> bytes | None:
    """Blocks of data deflated over threads: BGZF members (bgzf=True,
    0xff00 bytes a block, no EOF block) or multi-member gzip; None where
    the library is unavailable (native.py:552-568)."""
    lib = _load()
    if lib is None:
        return None
    if nthreads is None:
        nthreads = os.cpu_count() or 2
    n = len(data)
    cap = n + n // 2 + 65536
    out = np.empty(cap, np.uint8)
    wrote = lib.compress_blocks(data, n, out.ctypes.data_as(_vp), cap,
                                nthreads, level, 1 if bgzf else 0)
    if wrote < 0:
        return None
    return out[:int(wrote)].tobytes()


def sam_scatter(text: bytes, chrom_names: list[str], min_mapq: int):
    """Tokenize SAM text into pileup scatter runs and indel events in one
    C pass (the GoPileup per-read walk, sam/pileup.go:221-311). Returns
    (starts, lens, fwds, refidxs, bases, del_ev (n, 4), ins_ev (n, 5),
    ins_str bytes) or None."""
    lib = _load()
    if lib is None:
        return None
    nm = "\n".join(chrom_names).encode()
    n = len(text)
    run_cap = max(1024, n // 8)
    base_cap = max(4096, n)
    del_cap = ins_cap = max(1024, n // 64)
    starts = np.empty(run_cap, np.int32)
    lens = np.empty(run_cap, np.int32)
    fwds = np.empty(run_cap, np.uint8)
    ridx = np.empty(run_cap, np.int32)
    bases = np.empty(base_cap, np.int8)
    del_ev = np.empty(del_cap * 4, np.int32)
    ins_ev = np.empty(ins_cap * 5, np.int32)
    ins_str = np.empty(base_cap, np.uint8)
    counts = np.zeros(5, np.int64)
    rc = lib.sam_scatter(
        text, n, nm, len(nm), min_mapq,
        starts.ctypes.data_as(_vp), lens.ctypes.data_as(_vp),
        fwds.ctypes.data_as(_vp), ridx.ctypes.data_as(_vp), run_cap,
        bases.ctypes.data_as(_vp), base_cap,
        del_ev.ctypes.data_as(_vp), del_cap,
        ins_ev.ctypes.data_as(_vp), ins_cap,
        ins_str.ctypes.data_as(_vp), base_cap,
        counts.ctypes.data_as(_vp))
    if rc != 0:
        return None
    n_runs, n_bases, n_del, n_ins, ins_len = (int(x) for x in counts)
    return (starts[:n_runs], lens[:n_runs], fwds[:n_runs], ridx[:n_runs],
            bases[:n_bases], del_ev[:n_del * 4].reshape(-1, 4),
            ins_ev[:n_ins * 5].reshape(-1, 5),
            ins_str[:ins_len].tobytes())


def runs_to_counts(starts, lens, fwds, ridx, bases, want_refidx: int,
                   lo: int, span: int, nthreads: int = 0):
    """Scatter the (start, len, fwd, refidx) pileup runs of one chromosome
    into a dense (span, 13, 2) count tensor in one C pass, with the
    strand-summed (span, 13) matrix and the depth a position of the same
    pass. The counts are int16 unless a cell passes 32,767, then int32.
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    starts = np.ascontiguousarray(starts, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    fwds = np.ascontiguousarray(fwds, np.uint8)
    ridx = np.ascontiguousarray(ridx, np.int32)
    bases = np.ascontiguousarray(bases, np.int8)
    cnt2 = np.zeros((span, 13), np.int32)
    depth = np.zeros(span, np.int32)
    ins = [x.ctypes.data_as(_vp) for x in (starts, lens, fwds, ridx, bases)]
    outs = (cnt2.ctypes.data_as(_vp), depth.ctypes.data_as(_vp), nthreads)
    counts16 = np.zeros((span, 13, 2), np.int16)
    if lib.runs_to_counts(*ins, len(starts), want_refidx, lo, span, None,
                          counts16.ctypes.data_as(_vp), *outs) == 0:
        return counts16, cnt2, depth
    counts = np.zeros((span, 13, 2), np.int32)
    lib.runs_to_counts(*ins, len(starts), want_refidx, lo, span,
                       counts.ctypes.data_as(_vp), None, *outs)
    return counts, cnt2, depth


def cv_prescreen(cnt2_list, depth_list, offs, spans, ins_pos, ins_tot,
                 ins_off, del_pos, del_off, n_exp: int, L: int, lo: int,
                 refarr, min_coverage: int, nthreads: int = 0):
    """The variant caller's candidate prescreen in one threaded C pass:
    (exists bool (n_samp, L), depths int32, expsum int32 (L, 13), cand
    bool, indel_pos bool, n_sites), or None."""
    lib = _load()
    if lib is None:
        return None
    n_samp = len(cnt2_list)
    cnt2_list = [np.ascontiguousarray(x, np.int32) for x in cnt2_list]
    depth_list = [np.ascontiguousarray(x, np.int32) for x in depth_list]
    cptr = np.array([x.ctypes.data for x in cnt2_list], np.uintp)
    dptr = np.array([x.ctypes.data for x in depth_list], np.uintp)
    args = [np.ascontiguousarray(x, t) for x, t in (
        (offs, np.int64), (spans, np.int64), (ins_pos, np.int32),
        (ins_tot, np.int32), (ins_off, np.int64), (del_pos, np.int32),
        (del_off, np.int64))]
    refarr = np.ascontiguousarray(refarr, np.int8)
    exists = np.empty((n_samp, L), np.uint8)
    depths = np.empty((n_samp, L), np.int32)
    expsum = np.empty((L, 13), np.int32)
    cand = np.empty(L, np.uint8)
    indel_pos = np.empty(L, np.uint8)
    n_sites = lib.cv_prescreen(
        cptr.ctypes.data_as(_vp), dptr.ctypes.data_as(_vp),
        *[x.ctypes.data_as(_vp) for x in args],
        n_samp, n_exp, L, lo, refarr.ctypes.data_as(_vp), len(refarr),
        min_coverage, *[x.ctypes.data_as(_vp) for x in (
            exists, depths, expsum, cand, indel_pos)], _threads(nthreads))
    return (exists.view(bool), depths, expsum, cand.view(bool),
            indel_pos.view(bool), int(n_sites))


def cv_snv_pass(counts_list, clo, cspan, exists, depths, expsum,
                ref_codes, idx, n_exp: int, max_p: float, min_af: float,
                max_af: float, max_strand_bias: float, min_coverage: int,
                min_alt_reads: int, nthreads: int = 0):
    """The variant caller's SNV decision cascade and Fisher tail over
    candidate sites in one threaded C pass (``_vector_snv_pass``'s
    semantics, no miss): a bool (C,) site-pass mask, or None."""
    lib = _load()
    if lib is None:
        return None
    n_samp = len(counts_list)
    dts = {c.dtype for c in counts_list if c is not None}
    # mixed dtypes (one sample's scatter saturated to int32): widen all
    dt = np.int16 if dts == {np.dtype(np.int16)} else np.int32
    keep = [None if c is None else np.ascontiguousarray(c, dt)
            for c in counts_list]
    ptrs = np.array([0 if c is None else c.ctypes.data for c in keep],
                    np.uintp)
    args = [np.ascontiguousarray(x, t) for x, t in (
        (clo, np.int64), (cspan, np.int64), (exists, np.uint8),
        (depths, np.int32), (expsum, np.int32), (ref_codes, np.int8),
        (idx, np.int64))]
    L = args[2].shape[1]
    out = np.zeros(len(args[6]), np.uint8)
    lib.cv_snv_pass(ptrs.ctypes.data_as(_vp),
                    *[x.ctypes.data_as(_vp) for x in args],
                    len(args[6]), L, 0, n_samp, n_exp,
                    max_p, min_af, max_af, max_strand_bias,
                    min_coverage, min_alt_reads, int(dt == np.int16),
                    out.ctypes.data_as(_vp), _threads(nthreads))
    return out.view(bool)
