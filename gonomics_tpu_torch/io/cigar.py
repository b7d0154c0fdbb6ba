"""SAM cigar run-length ops: the subset of ``gonomics_tpu/io/cigar.py``
that SAM and giraf emission use."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CigarOp:
    run_length: int
    op: str


_CONSUMES_QUERY = set("MIS=X")


def query_length(cig: list[CigarOp]) -> int:
    """Read bases the cigar consumes (cigar.py:58)."""
    return sum(c.run_length for c in cig if c.op in _CONSUMES_QUERY)


def to_string(cig: list[CigarOp]) -> str:
    if not cig:
        return "*"
    if cig[0].op == "*":
        return "*"
    return "".join(f"{c.run_length}{c.op}" for c in cig)
