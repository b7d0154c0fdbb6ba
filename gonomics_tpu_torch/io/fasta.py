"""FASTA records and reading: the subset of ``gonomics_tpu/io/fasta.py``
that the read aligner and the ``gsw`` CLI use."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterator

import numpy as np

from .. import dna, fileio


@dataclass
class Fasta:
    name: str
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int8))


def _parse(f: IO[str]) -> Iterator[Fasta]:
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
            chunks.append(dna.from_string(line))
    if name is not None:
        yield Fasta(name, _concat(chunks))


def _concat(chunks: list[np.ndarray]) -> np.ndarray:
    if not chunks:
        return np.zeros(0, dtype=np.int8)
    return np.concatenate(chunks)


def read(filename: str) -> list[Fasta]:
    """All records of a FASTA file; names must be unique."""
    with fileio.easy_open(filename) as f:
        records = list(_parse(f))
    names = [r.name for r in records]
    if len(set(names)) != len(names):
        raise ValueError("fasta record names must be unique")
    return records
