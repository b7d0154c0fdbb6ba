"""Alignment cigar run-length encoding (gonomics ``align.Cigar``,
align.go:12-26): a copy of ``gonomics_tpu/align/cigar.py``. This is the
pairwise aligner's cigar, not the SAM one in ``io/cigar.py``.

Op codes: M=0 (consume both), I=1 (gap in alpha / consume beta),
D=2 (gap in beta / consume alpha), the same as gonomics' ColType.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna

COL_M = 0
COL_I = 1
COL_D = 2

_OP_CHAR = "MID"


@dataclass
class Cigar:
    run_length: int
    op: int

    def __repr__(self) -> str:  # Go fmt "%v" of align.Cigar: "{5 0}"
        return f"{{{self.run_length} {self.op}}}"


def go_format(route: list[Cigar]) -> str:
    """Format exactly like Go's %v of []align.Cigar: "[{5 0} {1 2}]"."""
    return "[" + " ".join(repr(c) for c in route) + "]"


def print_cigar(route: list[Cigar]) -> str:
    """align.PrintCigar (view.go:26): e.g. '5M1D3M'."""
    return "".join(f"{c.run_length}{_OP_CHAR[c.op]}" for c in route)


def view(alpha: np.ndarray, beta: np.ndarray, route: list[Cigar]) -> str:
    """align.View (view.go:37): two-row human-readable alignment, each row
    newline-terminated."""
    one: list[str] = []
    two: list[str] = []
    i = j = 0
    alpha = np.asarray(alpha)
    beta = np.asarray(beta)
    for c in route:
        n = c.run_length
        if c.op == COL_M:
            one.append(dna.to_string(alpha[i:i + n]))
            two.append(dna.to_string(beta[j:j + n]))
            i += n
            j += n
        elif c.op == COL_I:
            one.append("-" * n)
            two.append(dna.to_string(beta[j:j + n]))
            j += n
        elif c.op == COL_D:
            one.append(dna.to_string(alpha[i:i + n]))
            two.append("-" * n)
            i += n
        else:
            raise ValueError(f"unexpected cigar op {c.op}")
    return "".join(one) + "\n" + "".join(two) + "\n"


def runs_from_ops(ops: list[int]) -> list[Cigar]:
    """Merge a per-step op list (in alignment order) into run-length runs."""
    route: list[Cigar] = []
    for op in ops:
        if route and route[-1].op == op:
            route[-1].run_length += 1
        else:
            route.append(Cigar(1, op))
    return route
