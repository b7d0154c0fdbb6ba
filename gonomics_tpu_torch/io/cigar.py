"""SAM cigar run-length ops: the subset of ``gonomics_tpu/io/cigar.py``
that SAM and giraf emission, the SAM readers, the pileup and
``samToBed`` use."""

from __future__ import annotations

from dataclasses import dataclass

OP_TABLE = "MIDNSHP=X"  # BAM numeric op -> char

_CONSUMES_REF = set("MDN=X")
_CONSUMES_QUERY = set("MIS=X")


@dataclass
class CigarOp:
    run_length: int
    op: str


def consumes_reference(op: str) -> bool:
    return op in _CONSUMES_REF


def consumes_query(op: str) -> bool:
    return op in _CONSUMES_QUERY


def is_unmapped(cig: list[CigarOp]) -> bool:
    """'*' cigar or empty (cigar.IsUnmapped)."""
    return len(cig) == 0 or cig[0].op == "*"


def query_length(cig: list[CigarOp]) -> int:
    """Read bases the cigar consumes (cigar.py:58)."""
    return sum(c.run_length for c in cig if c.op in _CONSUMES_QUERY)


def reference_length(cig: list[CigarOp]) -> int:
    """Reference bases the cigar consumes (cigar.py:62)."""
    return sum(c.run_length for c in cig if c.op in _CONSUMES_REF)


def to_string(cig: list[CigarOp]) -> str:
    if not cig:
        return "*"
    if cig[0].op == "*":
        return "*"
    return "".join(f"{c.run_length}{c.op}" for c in cig)


def from_string(s: str) -> list[CigarOp]:
    if s == "*" or s == "":
        return [CigarOp(0, "*")] if s == "*" else []
    out: list[CigarOp] = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append(CigarOp(n, ch))
            n = 0
    return out
