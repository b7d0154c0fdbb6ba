"""Probabilistic FASTA (``.pfa``): records of per-base A, C, G and T
probabilities, the part of ``gonomics_tpu/io/pfasta.py`` that
reconstructSeq's ``-pDnaNode`` writes (``MAGIC``, ``PFasta``, ``write``
:15-33 and ``read`` :206-233), gonomics' ``fasta/pFasta/pFasta.go``.

A file is a text header (``pFasta_format_1.0``, a ``name\\tlength``
line a record, ``EndHeader``) and then each record's (length, 4)
probabilities as little-endian float16. In memory a sequence is a
(length, 4) float32 array.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAGIC = "pFasta_format_1.0"


@dataclass
class PFasta:
    name: str
    seq: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))


def write(filename: str, records: list[PFasta]) -> None:
    with open(filename, "wb") as f:
        f.write((MAGIC + "\n").encode())
        for r in records:
            f.write(f"{r.name}\t{len(r.seq)}\n".encode())
        f.write(b"EndHeader\n")
        for r in records:
            f.write(np.asarray(r.seq, np.float32).astype("<f2").tobytes())


def read(filename: str) -> list[PFasta]:
    with open(filename, "rb") as f:
        data = f.read()
    # header is newline-terminated text lines
    lines = []
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode()
        pos = nl + 1
        lines.append(line)
        if line == "EndHeader":
            break
    if lines[0] != MAGIC:
        raise ValueError(f"unrecognized pFasta format: {lines[0]}")
    records = []
    for line in lines[1:-1]:
        name, n = line.rsplit("\t", 1)
        records.append(PFasta(name, np.zeros((int(n), 4), np.float32)))
    body = np.frombuffer(data[pos:], dtype="<f2")
    off = 0
    for r in records:
        n = len(r.seq) * 4
        r.seq = body[off:off + n].astype(np.float32).reshape(-1, 4)
        off += n
    if off != len(body):
        raise ValueError("trailing bytes in pFasta file")
    return records
