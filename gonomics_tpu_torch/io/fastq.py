"""FASTQ records and reading: the subset of ``gonomics_tpu/io/fastq.py``
that the read aligners and the ``gsw`` CLI use."""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from .. import dna, fileio, native

ASCII_OFFSET = 33


@dataclass
class Fastq:
    name: str = ""
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))


@dataclass
class FastqBig:
    """A read with its reverse complement (fastq.py:29)."""

    name: str = ""
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    seq_rc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))


def qual_string(qual: np.ndarray) -> str:
    return (np.asarray(qual, np.uint8) + ASCII_OFFSET).tobytes().decode("latin-1")


def _to_qual(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8) - ASCII_OFFSET


def _next_fastq(f) -> Fastq | None:
    name = f.readline()
    if not name:
        return None
    seq = f.readline().rstrip("\n")
    plus = f.readline().rstrip("\n")
    if not plus.startswith("+"):
        raise ValueError("malformed fastq: expected '+' line")
    qual = f.readline().rstrip("\n")
    return Fastq(name=name.rstrip("\n")[1:],
                 seq=dna.from_string(seq), qual=_to_qual(qual))


def read(filename: str) -> list[Fastq]:
    """All records of a FASTQ file, through the native tokenizer when the
    host library builds, else line by line in Python."""
    with fileio.easy_open_binary(filename) as fb:
        data = fb.read()
    if data and not data.startswith(b"@"):
        raise ValueError("malformed fastq: expected '@' header")
    n_records = data.count(b"\n") // 4 + 1
    parsed = None
    if data:
        seq_lines = data.split(b"\n")[1::4]
        max_len = max((len(ln) for ln in seq_lines), default=0)
        if max_len > 0:
            parsed = native.fastq_parse_batch(data, n_records, max_len)
    if parsed is not None:
        names, seqs, quals, lens = parsed
        return [Fastq(names[i], seqs[i, :lens[i]].copy(),
                      quals[i, :lens[i]].copy())
                for i in range(len(names))]
    out = []
    with io.TextIOWrapper(io.BytesIO(data), encoding="utf-8") as f:
        while (fq := _next_fastq(f)) is not None:
            out.append(fq)
    return out


def to_big(fq: Fastq) -> FastqBig:
    """The read as a FastqBig, its name cut at the first space
    (fastq.py:90)."""
    return FastqBig(name=fq.name.split(" ")[0], seq=fq.seq,
                    seq_rc=dna.reverse_complement(fq.seq).astype(np.int8),
                    qual=fq.qual)


def read_pairs_big(file_one: str, file_two: str) -> list[tuple[FastqBig, FastqBig]]:
    """Both files of a read pair, record by record (fastq.py:97)."""
    r1 = read(file_one)
    r2 = read(file_two)
    if len(r1) != len(r2):
        raise ValueError("fastq files do not end at the same time")
    return [(to_big(a), to_big(b)) for a, b in zip(r1, r2)]
