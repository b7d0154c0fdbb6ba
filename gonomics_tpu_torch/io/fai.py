"""The .fai FASTA index and its random-access ``Seeker``: a copy of
``gonomics_tpu/io/fai.py``. ``seek_by_name`` returns the bases of 0-based
[start, end) of a chromosome, cut at its end (seeker.go:88-140)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna


@dataclass(frozen=True)
class ChrOffset:
    name: str
    length: int
    offset: int      # byte offset of first sequence byte
    line_bases: int  # bases per line
    line_bytes: int  # bytes per line incl newline


def read_index(filename: str) -> list[ChrOffset]:
    out = []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            n, ln, off, lb, lw = line.rstrip("\n").split("\t")
            out.append(ChrOffset(n, int(ln), int(off), int(lb), int(lw)))
    return out


def create_index(fasta_path: str) -> list[ChrOffset]:
    """The index of a FASTA file, by scanning it (fai.go:48)."""
    out = []
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_bytes = 0
        pos = 0
        for raw in f:
            if raw.startswith(b">"):
                if name is not None:
                    out.append(ChrOffset(name, length, offset, line_bases,
                                         line_bytes))
                name = raw[1:].split()[0].decode()
                length = 0
                offset = pos + len(raw)
                line_bases = 0
                line_bytes = 0
            else:
                stripped = raw.rstrip(b"\r\n")
                if line_bases == 0 and stripped:
                    line_bases = len(stripped)
                    line_bytes = len(raw)
                length += len(stripped)
            pos += len(raw)
        if name is not None:
            out.append(ChrOffset(name, length, offset, line_bases, line_bytes))
    return out


def write_index(idx: list[ChrOffset], filename: str) -> None:
    with open(filename, "w") as f:
        for c in idx:
            f.write(f"{c.name}\t{c.length}\t{c.offset}\t{c.line_bases}\t"
                    f"{c.line_bytes}\n")


class Seeker:
    """Random access to a FASTA file through its .fai index
    (fasta.Seeker, seeker.go:15)."""

    def __init__(self, fasta_path: str, index_path: str = ""):
        if fasta_path.endswith(".gz"):
            raise ValueError("fasta seeker is not compatible with gzipped "
                             "files")
        self.file = open(fasta_path, "rb")
        self.chroms = read_index(index_path or fasta_path + ".fai")
        self.by_name = {c.name: c for c in self.chroms}

    def close(self) -> None:
        self.file.close()

    def seek_by_name(self, chrom: str, start: int, end: int) -> np.ndarray:
        """Bases covering 0-based [start, end), cut at the chromosome's
        end."""
        if chrom not in self.by_name:
            raise KeyError(f"could not find sequence for fasta record "
                           f"'{chrom}'")
        c = self.by_name[chrom]
        if start > end or start < 0:
            raise ValueError("bad seek range")
        end = min(end, c.length)
        if start >= end:
            return np.zeros(0, np.int8)
        first_line, first_col = divmod(start, c.line_bases)
        last_line, last_col = divmod(end - 1, c.line_bases)
        byte_start = c.offset + first_line * c.line_bytes + first_col
        byte_end = c.offset + last_line * c.line_bytes + last_col + 1
        self.file.seek(byte_start)
        raw = self.file.read(byte_end - byte_start)
        seq = raw.replace(b"\n", b"").replace(b"\r", b"")
        return dna.from_string(seq)
