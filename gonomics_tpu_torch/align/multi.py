"""Progressive multiple alignment (gonomics ``align.AllSeqAffine``,
multiAlign.go:59): the part of ``gonomics_tpu/align/multi.py`` that
``dunnIndex -realign`` runs.

Copied: ``_column_profile``, ``_pair_sub_matrix`` and ``_merge_groups``
(:19-76) and ``all_seq_affine`` (:128-147). Greedy nearest-group
merging with the affine DP of ``align/oracle.py`` over group columns;
the column-pair score (scoreColumnMatch, multiAlign.go:82) is computed
for all column pairs at once as one-hot counts x scores x counts,
followed by the reference's truncating integer division.
"""

from __future__ import annotations

import numpy as np

from .. import dna
from ..io import fasta as fastaio
from . import oracle
from .cigar import COL_D, COL_I, COL_M, Cigar

def _column_profile(group: list[fastaio.Fasta]):
    """(cols, 5) counts of folded bases + (cols,) non-gap counts."""
    mat = np.stack([np.asarray(r.seq, np.int64) for r in group])
    folded = np.where((mat >= 5) & (mat <= 9), mat - 5, mat)
    cols = mat.shape[1]
    counts = np.zeros((cols, 5), np.int64)
    nongap = folded != dna.GAP
    for b in range(5):
        counts[:, b] = ((folded == b) & nongap).sum(axis=0)
    return counts, nongap.sum(axis=0)


def _pair_sub_matrix(alpha: list[fastaio.Fasta], beta: list[fastaio.Fasta],
                     scores: np.ndarray) -> np.ndarray:
    """S[i, j] = scoreColumnMatch(alpha, beta, i, j): truncated-toward-zero
    average of pair scores over non-gap pairs."""
    ca, na = _column_profile(alpha)
    cb, nb = _column_profile(beta)
    sc = np.asarray(scores, np.int64)[:5, :5]
    total = ca @ sc @ cb.T                      # (colsA, colsB)
    count = na[:, None] * nb[None, :]
    if (count == 0).any():
        raise ZeroDivisionError("column pair with no non-gap bases")
    q = np.abs(total) // count
    return (np.sign(total) * q).astype(np.int64)


def _merge_groups(alpha: list[fastaio.Fasta], beta: list[fastaio.Fasta],
                  route: list[Cigar]) -> list[fastaio.Fasta]:
    """mergeMultipleAlignments (multiAlign.go:110)."""
    total = sum(c.run_length for c in route)
    out = [fastaio.Fasta(r.name, np.zeros(total, np.int8))
           for r in alpha + beta]
    a_col = b_col = col = 0
    for c in route:
        for _ in range(c.run_length):
            for k, rec in enumerate(out):
                if k < len(alpha):
                    if c.op in (COL_M, COL_D):
                        rec.seq[col] = alpha[k].seq[a_col]
                    else:
                        rec.seq[col] = dna.GAP
                else:
                    if c.op in (COL_M, COL_I):
                        rec.seq[col] = beta[k - len(alpha)].seq[b_col]
                    else:
                        rec.seq[col] = dna.GAP
            if c.op == COL_M:
                a_col += 1
                b_col += 1
            elif c.op == COL_I:
                b_col += 1
            else:
                a_col += 1
            col += 1
    return out


def all_seq_affine(records: list[fastaio.Fasta], scores: np.ndarray,
                   gap_open: int, gap_extend: int) -> list[fastaio.Fasta]:
    """align.AllSeqAffine (multiAlign.go:59): greedy nearest-group
    progressive alignment."""
    groups = [[fastaio.Fasta(r.name, np.asarray(r.seq, np.int8))]
              for r in records]
    while len(groups) > 1:
        best = None
        for x in range(len(groups) - 1):
            for y in range(x + 1, len(groups)):
                sub = _pair_sub_matrix(groups[x], groups[y], scores)
                score, route = oracle.affine_gap_from_sub(sub, gap_open,
                                                          gap_extend)
                if best is None or score > best[0]:
                    best = (score, x, y, route)
        _, x, y, route = best
        groups[x] = _merge_groups(groups[x], groups[y], route)
        groups[y] = groups[-1]
        groups.pop()
    return groups[0]
