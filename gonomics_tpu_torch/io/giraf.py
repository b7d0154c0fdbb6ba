"""Giraf graph-alignment records and their text form: a copy of
``gonomics_tpu/io/giraf.py`` (113 lines, whole), gonomics' ``giraf``
(giraf.go, convert.go).

Text format: QName QStart QEnd Flag Strand Path Cigar AlnScore MapQ Seq
Qual [Notes...], the path as TStart:node>node>...:TEnd.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna, fileio
from . import cigar as samcigar
from .fastq import qual_string, to_qual


@dataclass
class Note:
    tag: str
    type: str
    value: str

    def to_string(self) -> str:
        return f"{self.tag}:{self.type}:{self.value}"


@dataclass
class Path:
    t_start: int = 0
    nodes: list[int] = field(default_factory=list)
    t_end: int = 0


@dataclass
class Giraf:
    qname: str = ""
    q_start: int = 0
    q_end: int = 0
    flag: int = 0
    pos_strand: bool = True
    path: Path = field(default_factory=Path)
    cigar: list[samcigar.CigarOp] = field(default_factory=list)
    aln_score: int = 0
    mapq: int = 255
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    qual: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    notes: list[Note] = field(default_factory=list)


def _full_path_string(p: Path) -> str:
    """giraf PathToString (convert.go:48): TStart:node>node>...:TEnd."""
    return f"{p.t_start}:{'>'.join(str(n) for n in p.nodes)}:{p.t_end}"


def to_string(g: Giraf) -> str:
    strand = "+" if g.pos_strand else "-"
    cig = samcigar.to_string(g.cigar) if g.cigar else "*"
    notes = "".join("\t" + n.to_string() for n in g.notes)
    return (f"{g.qname}\t{g.q_start}\t{g.q_end}\t{g.flag}\t{strand}\t"
            f"{_full_path_string(g.path)}\t{cig}\t{g.aln_score}\t{g.mapq}\t"
            f"{dna.to_string(g.seq)}\t{qual_string(g.qual)}{notes}")


def write(filename: str, records) -> None:
    with fileio.easy_create(filename) as f:
        for g in records:
            f.write(to_string(g) + "\n")


def _path_from_string(column: str) -> Path:
    """giraf.FromStringToPath (convert.go:56)."""
    words = column.split(":")
    if len(words) != 3:
        raise ValueError(f"Needs exact 3 values, only found {len(words)}")
    nodes = [int(x) for x in words[1].split(">")] if words[1] else []
    return Path(t_start=int(words[0]), nodes=nodes, t_end=int(words[2]))


def _notes_from_string(s: str) -> list[Note]:
    """giraf.FromStringToNotes (convert.go:110)."""
    out = []
    for v in s.split("\t"):
        tag, typ, value = v.split(":", 2)
        out.append(Note(tag=tag, type=typ, value=value))
    return out


def process_giraf_line(line: str) -> Giraf:
    """giraf processGirafLine (convert.go:25): the notes tail stays one
    logical column (SplitN with n=12 in Go)."""
    data = line.split("\t", 11)
    if len(data) <= 10:
        raise ValueError(f"Expecting at least 11 columns, but only found "
                         f"{len(data)} on {line}")
    g = Giraf(qname=data[0], q_start=int(data[1]), q_end=int(data[2]),
              flag=int(data[3]), pos_strand=data[4] == "+",
              path=_path_from_string(data[5]),
              cigar=samcigar.from_string(data[6]),
              aln_score=int(data[7]), mapq=int(data[8]),
              seq=dna.from_string(data[9]), qual=to_qual(data[10]))
    if len(data) == 12:
        g.notes = _notes_from_string(data[11])
    return g


def read(filename: str) -> list[Giraf]:
    """giraf.Read: parse a text .giraf file."""
    with fileio.easy_open(filename) as f:
        return [process_giraf_line(ln) for ln in fileio.real_lines(f)
                if ln.strip()]
