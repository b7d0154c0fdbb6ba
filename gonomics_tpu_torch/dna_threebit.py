"""3-bit packed DNA (A,C,G,T,N + two padding symbols) in uint64 words:
a copy of ``gonomics_tpu/dna_threebit.py`` (131 lines, whole),
gonomics' ``dna/dnaThreeBit`` (dnaThreeBit.go:16-126, convert.go,
modify.go), the sequence form of the binary giraf format.

21 bases per word, packed from the most significant bits; the least
significant bit of each word is unused. Padding bases (5/6) fill the
tail of the last word so two differently padded sequences never match
there. Packing reshapes to (words, 21) and sums the shifted values,
whose bits are disjoint, all in np.uint64; only Append walks base by
base.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import dna

A, C, G, T, N = 0, 1, 2, 3, 4
PADDING_ONE, PADDING_TWO = 5, 6

_BASE_CHARS = "ACGTN"


@dataclass
class ThreeBit:
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    len: int = 0


def bases_to_uint64(seq: np.ndarray, start: int, end: int,
                    padding: int) -> int:
    """dnaThreeBit.BasesToUint64 (dnaThreeBit.go:54): pack seq[start:end]
    (<= 21 bases) into one word, padding the tail."""
    if end - start > 21 or start >= end:
        raise ValueError(f"when converting to ThreeBit. start={start} "
                         f"end={end}")
    vals = np.full(21, padding, np.uint64)
    chunk = np.asarray(seq[start:end], np.uint64)
    vals[:end - start] = chunk
    shifts = np.uint64(3) * np.arange(20, -1, -1, dtype=np.uint64)
    return int(((vals << np.uint64(1)) << shifts).sum(dtype=np.uint64))


def new_three_bit(seq: np.ndarray, padding: int) -> ThreeBit:
    """dnaThreeBit.NewThreeBit (dnaThreeBit.go:113), vectorized."""
    seq = np.asarray(seq, np.uint64)
    n = len(seq)
    n_words = (n + 20) // 21
    vals = np.full(n_words * 21, padding, np.uint64)
    vals[:n] = seq
    vals = vals.reshape(n_words, 21)
    shifts = np.uint64(3) * np.arange(20, -1, -1, dtype=np.uint64)
    words = ((vals << np.uint64(1)) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64)
    return ThreeBit(seq=words, len=n)


def get_three_bit_base(fragment: ThreeBit, pos: int) -> int:
    """dnaThreeBit.GetThreeBitBase (dnaThreeBit.go:96)."""
    if pos < 0 or pos >= fragment.len:
        raise IndexError(f"asked for base at position:{pos} for a sequence "
                         f"with length:{fragment.len}")
    idx, rem = divmod(pos, 21)
    shift = np.uint64(64 - 3 * (rem + 1))
    return int((fragment.seq[idx] >> shift) & np.uint64(7))


def get_base(fragment: ThreeBit, pos: int) -> int:
    return get_three_bit_base(fragment, pos)


def to_dna_bases(fragment: ThreeBit) -> np.ndarray:
    """dnaThreeBit.ToDnaBases (convert.go:99), vectorized unpack."""
    return range_to_dna_bases(fragment, 0, fragment.len)


def range_to_dna_bases(fragment: ThreeBit, start: int,
                       end: int) -> np.ndarray:
    """dnaThreeBit.RangeToDnaBases (convert.go:84)."""
    if end > fragment.len or start >= end:
        raise ValueError(f"unable to extract bases from {start} to {end} "
                         f"from a sequence of length {fragment.len}")
    # group i sits at bits [61-3i .. 63-3i] (GetThreeBitBase shift math)
    shifts = np.uint64(3) * np.arange(20, -1, -1, dtype=np.uint64) \
        + np.uint64(1)
    all_bases = (fragment.seq[:, None] >> shifts[None, :]) & np.uint64(7)
    return all_bases.reshape(-1)[start:end].astype(np.int8)


def from_string(s: str) -> ThreeBit:
    """dnaThreeBit.FromString (convert.go:63)."""
    return new_three_bit(dna.from_string(s.upper()), A)


def to_string(fragment: ThreeBit) -> str:
    """dnaThreeBit.ToString (convert.go:73)."""
    return dna.to_string(to_dna_bases(fragment))


def append(fragment: ThreeBit | None, b: int) -> ThreeBit:
    """dnaThreeBit.Append (modify.go:5)."""
    bnum = np.uint64(b)
    if fragment is None:
        return ThreeBit(seq=np.array([bnum << np.uint64(61)], np.uint64),
                        len=1)
    in_last = fragment.len % 21
    if in_last == 0:
        fragment.seq = np.append(fragment.seq, bnum << np.uint64(61))
    else:
        fragment.seq[-1] |= bnum << np.uint64(61 - in_last * 3)
    fragment.len += 1
    return fragment


def cat(a: ThreeBit, b: ThreeBit | None) -> None:
    """dnaThreeBit.Cat (modify.go:23)."""
    if b is None:
        return
    for i in range(b.len):
        append(a, get_three_bit_base(b, i))


def copy(a: ThreeBit | None) -> ThreeBit | None:
    if a is None:
        return None
    return ThreeBit(seq=a.seq.copy(), len=a.len)
