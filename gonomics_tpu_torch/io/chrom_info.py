"""Chromosome name and size records (mirrors
``gonomics_tpu/io/chrom_info.py``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChromInfo:
    name: str
    size: int
    order: int = 0
