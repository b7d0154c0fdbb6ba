"""FASTA records, reading and writing: the subset of
``gonomics_tpu/io/fasta.py`` that the read aligner, the ``gsw`` CLI,
``samConsensus`` and ``faFormat`` use (``_parse`` :34, ``read`` :57,
``read_forced`` :67, ``write_fasta`` :86, ``write`` :95,
``aln_pos_to_ref_pos_counter`` :133)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterator

import numpy as np

from .. import dna, fileio


@dataclass
class Fasta:
    name: str
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int8))


def _parse(f: IO[str], conv) -> Iterator[Fasta]:
    """The records of f, each sequence line converted by conv."""
    name: str | None = None
    chunks: list[np.ndarray] = []
    for line in fileio.real_lines(f):
        if line.startswith(">"):
            if name is not None:
                yield Fasta(name, _concat(chunks))
            name = line[1:]
            chunks = []
        elif line:
            if name is None:
                raise ValueError("fasta record missing a sequence name (e.g. >chr1)")
            chunks.append(conv(line))
    if name is not None:
        yield Fasta(name, _concat(chunks))


def _concat(chunks: list[np.ndarray]) -> np.ndarray:
    if not chunks:
        return np.zeros(0, dtype=np.int8)
    return np.concatenate(chunks)


def read(filename: str) -> list[Fasta]:
    """All records of a FASTA file; names must be unique."""
    with fileio.easy_open(filename) as f:
        records = list(_parse(f, dna.from_string))
    names = [r.name for r in records]
    if len(set(names)) != len(names):
        raise ValueError("fasta record names must be unique")
    return records


def read_forced(filename: str) -> list[Fasta]:
    """All records of a FASTA file, invalid characters masked to N (or
    to LOWER_N where lowercase); names may repeat (fasta.py:67-70)."""
    with fileio.easy_open(filename) as f:
        return list(_parse(f, dna.from_string_forced))


def write_fasta(f: IO[str], rec: Fasta, line_length: int = 50) -> None:
    """One record, its sequence in lines of line_length characters."""
    f.write(f">{rec.name}\n")
    s = np.asarray(rec.seq)
    for i in range(0, len(s), line_length):
        f.write(dna.to_string(s[i:i + line_length]))
        f.write("\n")


def write(filename: str, records: list[Fasta], line_length: int = 50) -> None:
    with fileio.easy_create(filename) as f:
        for rec in records:
            write_fasta(f, rec, line_length)


def aln_pos_to_ref_pos_counter(record: Fasta, aln_pos: int,
                               ref_start: int, aln_start: int) -> int:
    """The reference position of alignment column aln_pos: ref_start plus
    the non-gap columns in [aln_start, aln_pos), counted from column 0
    when aln_start lies past aln_pos (fasta.py:133-142)."""
    seq = np.asarray(record.seq)
    if aln_start > aln_pos:
        ref_start, aln_start = 0, 0
    if aln_pos > len(seq):
        raise IndexError("Ran out of chromosome.")
    return ref_start + int((seq[aln_start:aln_pos] != dna.GAP).sum())
