"""DNA base codes and sequence conversion: the subset of
``gonomics_tpu/dna.py`` that the read aligners, the variant caller, the
consensus tools, the fasta tools, digestGenome, the Dunn index,
alleleSplit and axTools use.

A sequence is an int8 numpy array of base codes 0..12, the same integer
codes as the reference's ``dna`` package.
"""

from __future__ import annotations

import numpy as np

A = 0
C = 1
G = 2
T = 3
N = 4
LOWER_A = 5
LOWER_C = 6
LOWER_G = 7
LOWER_T = 8
LOWER_N = 9
GAP = 10
DOT = 11
NIL = 12

NUM_BASES = 13

_BASE_TO_CHAR = np.frombuffer(b"ACGTNacgtn-.*", dtype=np.uint8)

_CHAR_TO_BASE = np.full(256, 255, dtype=np.uint8)  # 255 = invalid
for _i, _ch in enumerate(b"ACGTNacgtn-.*"):
    _CHAR_TO_BASE[_ch] = _i

_TO_UPPER = np.arange(NUM_BASES, dtype=np.int8)
_TO_UPPER[LOWER_A:LOWER_N + 1] = np.arange(A, N + 1, dtype=np.int8)
_TO_LOWER = np.arange(NUM_BASES, dtype=np.int8)
_TO_LOWER[A:N + 1] = np.arange(LOWER_A, LOWER_N + 1, dtype=np.int8)

# A<->T, C<->G, case preserved; N, gap, dot and nil map to themselves
_COMPLEMENT = np.array(
    [T, G, C, A, N, LOWER_T, LOWER_G, LOWER_C, LOWER_A, LOWER_N, GAP, DOT, NIL],
    dtype=np.int8,
)


class InvalidBaseError(ValueError):
    pass


def from_string(s: str | bytes) -> np.ndarray:
    """Strict conversion; raises on characters outside AaCcGgTtNn-.*"""
    raw = np.frombuffer(s.encode() if isinstance(s, str) else s, dtype=np.uint8)
    codes = _CHAR_TO_BASE[raw]
    if (codes == 255).any():
        bad = chr(int(raw[codes == 255][0]))
        raise InvalidBaseError(
            f"invalid base {bad!r}: only AaCcGgTtNn-.* are supported"
        )
    return codes.astype(np.int8)


def from_string_forced(s: str | bytes) -> np.ndarray:
    """Invalid characters masked to N, or to LOWER_N where the character
    is lowercase (dna.py:77-85)."""
    raw = np.frombuffer(s.encode() if isinstance(s, str) else s, dtype=np.uint8)
    codes = _CHAR_TO_BASE[raw]
    lower = (raw >= ord("a")) & (raw <= ord("z"))
    codes = np.where(codes == 255,
                     np.where(lower, np.uint8(LOWER_N), np.uint8(N)), codes)
    return codes.astype(np.int8)


_CHAR_TO_BASE_UPPER = np.full(256, N, dtype=np.int8)
for _i, _ch in enumerate(b"ACGTN"):
    _CHAR_TO_BASE_UPPER[_ch] = _i
    _CHAR_TO_BASE_UPPER[_ch + 32] = _i  # lowercase -> upper code
_CHAR_TO_BASE_UPPER[ord("-")] = GAP
_CHAR_TO_BASE_UPPER[ord(".")] = DOT
_CHAR_TO_BASE_UPPER[ord("*")] = NIL


def from_string_upper_forced(s: str | bytes) -> np.ndarray:
    """Case folded, invalid characters to N, in one table lookup: how the
    SAM reader parses a read's bases (dna.py:97)."""
    raw = np.frombuffer(s.encode() if isinstance(s, str) else s,
                        dtype=np.uint8)
    return _CHAR_TO_BASE_UPPER[raw]


def to_string(seq: np.ndarray) -> str:
    seq = np.asarray(seq)
    return _BASE_TO_CHAR[seq.astype(np.int64)].tobytes().decode()


def to_upper(seq: np.ndarray) -> np.ndarray:
    return _TO_UPPER[np.asarray(seq)]


def to_lower(seq: np.ndarray) -> np.ndarray:
    """A..N to a..n; other codes unchanged (dna.py:117)."""
    return _TO_LOWER[np.asarray(seq)]


def define_base_mask(seq: np.ndarray) -> np.ndarray:
    """dna.DefineBase over an array (dna.py:226): True for A, C, G and T
    in either case; False for N, gaps, dots and Nil."""
    s = np.asarray(seq)
    return (s < 4) | ((s >= LOWER_A) & (s <= LOWER_T))


def all_gaps(n: int) -> np.ndarray:
    """n gap codes (dna.py:165)."""
    return np.full(n, GAP, dtype=np.int8)


def dist(a: np.ndarray, b: np.ndarray) -> int:
    """Hamming distance over equal-length seqs (dna/examine.go Dist;
    dna.py:175-180), which the Dunn index reads."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) != len(b):
        raise ValueError("Dist requires equal-length sequences")
    return int((a != b).sum())


def count_base(seq: np.ndarray, base: int) -> int:
    """The codes in seq equal to base (dna.py:136-138)."""
    return int((np.asarray(seq) == base).sum())


def complement(seq: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(seq).astype(np.int64)]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return complement(np.asarray(seq))[::-1]


def compare_seqs_case_sensitive(a: np.ndarray, b: np.ndarray) -> int:
    """dna.CompareSeqsCaseSensitive (dna.py:150): -1, 0 or 1 by the first
    differing code, else by length."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    if len(neq):
        i = neq[0]
        return -1 if a[i] < b[i] else 1
    return (len(a) > len(b)) - (len(a) < len(b))


def compare_seqs_ignore_case(a: np.ndarray, b: np.ndarray) -> int:
    """dna.CompareSeqsIgnoreCase (dna.py:161)."""
    return compare_seqs_case_sensitive(to_upper(a), to_upper(b))
