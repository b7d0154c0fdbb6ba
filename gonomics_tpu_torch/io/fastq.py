"""FASTQ records, reading and writing: the subset of
``gonomics_tpu/io/fastq.py`` that the read aligners, the ``gsw`` CLI,
``mergesort`` and the FASTQ tools use (``write`` :106-110, and the pair
I/O ``write_pairs``, ``write_to_handle``, ``read_pairs`` and
``to_single_cell_pair`` :113-148)."""

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


def to_qual(s: str | bytes) -> np.ndarray:
    raw = np.frombuffer(s.encode() if isinstance(s, str) else s, np.uint8)
    return raw - ASCII_OFFSET


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
                 seq=dna.from_string(seq), qual=to_qual(qual))


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


def write(filename: str, records: list[Fastq]) -> None:
    """Each record as its four lines (fastq.py:106-110)."""
    with fileio.easy_create(filename) as f:
        for fq in records:
            write_to_handle(f, fq)


def write_pairs(file_one: str, file_two: str,
                records: list[tuple[Fastq, Fastq]]) -> None:
    """The first mates to file_one, the second to file_two."""
    write(file_one, [a for a, _ in records])
    write(file_two, [b for _, b in records])


def write_to_handle(f, fq: Fastq) -> None:
    """One record's four lines to an open text handle."""
    f.write(f"@{fq.name}\n{dna.to_string(fq.seq)}\n+\n"
            f"{qual_string(fq.qual)}\n")


def read_pairs(file_one: str, file_two: str) -> list[tuple[Fastq, Fastq]]:
    """Both files of a read pair, record by record, each name cut at its
    first space; ValueError where the files differ in read count."""
    a, b = read(file_one), read(file_two)
    if len(a) != len(b):
        raise ValueError("paired fastq files have different read counts")
    for fq in a + b:
        fq.name = fq.name.split(" ")[0]
    return list(zip(a, b))


def to_single_cell_pair(fwd: Fastq, rev: Fastq, barcode_length: int,
                        umi_length: int):
    """A 10x pair renamed with its UMI and barcode, both taken off the
    forward read's start: (trimmed fwd, rev, barcode, umi)."""
    bx = np.array(fwd.seq[:barcode_length], copy=True)
    umi = np.array(fwd.seq[barcode_length:barcode_length + umi_length],
                   copy=True)
    tag = f"_UMI:{dna.to_string(umi)}_BX:{dna.to_string(bx)}"
    new_fwd = Fastq(fwd.name + tag,
                    fwd.seq[barcode_length + umi_length:],
                    fwd.qual[barcode_length + umi_length:])
    new_rev = Fastq(rev.name + tag, rev.seq, rev.qual)
    return new_fwd, new_rev, bx, umi
