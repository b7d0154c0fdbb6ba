"""SAM records and headers: the subset of ``gonomics_tpu/io/sam.py``
that the read aligner emits."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna
from . import cigar as samcigar
from .chrom_info import ChromInfo


@dataclass
class Sam:
    qname: str = ""
    flag: int = 0
    rname: str = "*"
    pos: int = 0          # 1-based leftmost position
    mapq: int = 0
    cigar: list[samcigar.CigarOp] = field(default_factory=list)
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    qual: str = "*"
    extra: str = ""

    def to_string(self) -> str:
        base = (f"{self.qname}\t{self.flag}\t{self.rname}\t{self.pos}\t"
                f"{self.mapq}\t{samcigar.to_string(self.cigar)}\t{self.rnext}\t"
                f"{self.pnext}\t{self.tlen}\t{dna.to_string(self.seq)}\t"
                f"{self.qual}")
        return base + (f"\t{self.extra}" if self.extra else "")


@dataclass
class Header:
    text: list[str] = field(default_factory=list)
    chroms: list[ChromInfo] = field(default_factory=list)
    sort_order: list[str] = field(default_factory=list)
