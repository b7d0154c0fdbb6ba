"""DNA base codes and sequence conversion: the subset of
``gonomics_tpu/dna.py`` that the read aligner uses.

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


def to_string(seq: np.ndarray) -> str:
    seq = np.asarray(seq)
    return _BASE_TO_CHAR[seq.astype(np.int64)].tobytes().decode()


def to_upper(seq: np.ndarray) -> np.ndarray:
    return _TO_UPPER[np.asarray(seq)]


def complement(seq: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(seq).astype(np.int64)]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return complement(np.asarray(seq))[::-1]
