"""SAM cigar run-length ops: the subset of ``gonomics_tpu/io/cigar.py``
that SAM emission uses."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CigarOp:
    run_length: int
    op: str


def to_string(cig: list[CigarOp]) -> str:
    if not cig:
        return "*"
    if cig[0].op == "*":
        return "*"
    return "".join(f"{c.run_length}{c.op}" for c in cig)
