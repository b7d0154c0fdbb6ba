"""BED records and writing: the subset of ``gonomics_tpu/io/bed.py`` that
``cigarToBed`` and ``samToBed`` use. Field-count-aware formatting matches
gonomics' ``bed.ToString``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

NONE = "."  # strand not given


@dataclass
class Bed:
    chrom: str = ""
    chrom_start: int = 0
    chrom_end: int = 0
    name: str = ""
    score: int = 0
    strand: str = NONE
    fields_initialized: int = 3
    annotation: list[str] = field(default_factory=list)

    def to_string(self, fields: int | None = None) -> str:
        n = self.fields_initialized if fields is None else fields
        if n < 3:
            raise ValueError(f"expecting at least 3 bed fields, got {n}")
        out = f"{self.chrom}\t{self.chrom_start}\t{self.chrom_end}"
        if n >= 4:
            out += f"\t{self.name}"
        if n >= 5:
            out += f"\t{self.score}"
        if n >= 6:
            out += f"\t{self.strand}"
        if n >= 7:
            for a in self.annotation:
                out += f"\t{a}"
        return out


def write_to_handle(f: IO[str], b: Bed) -> None:
    f.write(b.to_string() + "\n")
