"""ctypes bindings to the repository's host runtime ``native/seqio.cpp``,
for the helpers the read aligners call (mirrors the matching entries of
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
