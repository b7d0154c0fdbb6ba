"""Giraf graph-alignment records and their text form: the subset of
``gonomics_tpu/io/giraf.py`` (:19-62) that the graph aligner writes.

Text format: QName QStart QEnd Flag Strand Path Cigar AlnScore MapQ Seq
Qual [Notes...], the path as TStart:node>node>...:TEnd.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna
from . import cigar as samcigar
from .fastq import qual_string


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
    return f"{p.t_start}:{'>'.join(str(n) for n in p.nodes)}:{p.t_end}"


def to_string(g: Giraf) -> str:
    strand = "+" if g.pos_strand else "-"
    cig = samcigar.to_string(g.cigar) if g.cigar else "*"
    notes = "".join("\t" + n.to_string() for n in g.notes)
    return (f"{g.qname}\t{g.q_start}\t{g.q_end}\t{g.flag}\t{strand}\t"
            f"{_full_path_string(g.path)}\t{cig}\t{g.aln_score}\t{g.mapq}\t"
            f"{dna.to_string(g.seq)}\t{qual_string(g.qual)}{notes}")
