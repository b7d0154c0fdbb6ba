"""Progressive multiple alignment (gonomics ``align.AllSeqAffine`` and
``align.AllSeqAffineChunk``, multiAlign.go:59-70): a copy of
``gonomics_tpu/align/multi.py`` (147 lines, whole), which ``dunnIndex
-realign`` and ``faChunkAlign`` run.

``_column_profile``, ``_pair_sub_matrix`` and ``_merge_groups``
(:19-76), ``_chunk_sub_matrix`` and ``all_seq_affine_chunk`` (:77-125)
and ``all_seq_affine`` (:128-147). Greedy nearest-group merging with the
affine DP of ``align/oracle.py`` over group columns, on the host; the
column-pair score (scoreColumnMatch, multiAlign.go:82) is computed for
all column pairs at once as one-hot counts x scores x counts, followed
by the reference's truncating integer division. The chunk DP is that
recurrence over chunk pairs, its extend penalty scaled by the chunk
size.
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


def _chunk_sub_matrix(alpha: list[fastaio.Fasta], beta: list[fastaio.Fasta],
                      scores: np.ndarray, chunk_size: int) -> np.ndarray:
    """ungappedRegionColumnScore over chunk pairs
    (align/affineGap_highMem.go:104, multiAlign.go:104): chunk score
    (i, j) = sum_k scoreColumnMatch(i*cs+k, j*cs+k)."""
    for grp, which in ((alpha, "first"), (beta, "second")):
        if len(grp[0].seq) % chunk_size != 0:
            raise ValueError(
                f"Error: the {which} subalignment has a length of "
                f"{len(grp[0].seq)}, when it should be a multiple of "
                f"{chunk_size}")
    s = _pair_sub_matrix(alpha, beta, scores)
    na, nb = s.shape[0] // chunk_size, s.shape[1] // chunk_size
    out = np.zeros((na, nb), np.int64)
    for k in range(chunk_size):
        out += s[k::chunk_size, k::chunk_size][:na, :nb]
    return out


def all_seq_affine_chunk(records: list[fastaio.Fasta], scores: np.ndarray,
                         gap_open: int, gap_extend: int, chunk_size: int,
                         verbose: bool = False) -> list[fastaio.Fasta]:
    """align.AllSeqAffineChunk (multiAlign.go:70): greedy nearest-group
    progressive alignment in chunkSize units. The chunk DP
    (multipleAffineGapChunk, affineGap_highMem.go:138) is the standard
    affine recurrence with the extend penalty scaled by chunkSize, so it
    reuses affine_gap_from_sub; run lengths are then expanded back to
    bases (expandCigarRunLength, affineGap_highMem.go:91)."""
    groups = [[fastaio.Fasta(r.name, np.asarray(r.seq, np.int8))]
              for r in records]
    while len(groups) > 1:
        best = None
        for x in range(len(groups) - 1):
            for y in range(x + 1, len(groups)):
                sub = _chunk_sub_matrix(groups[x], groups[y], scores,
                                        chunk_size)
                score, route = oracle.affine_gap_from_sub(
                    sub, gap_open, gap_extend * chunk_size)
                if best is None or score > best[0]:
                    best = (score, x, y, route)
        score, x, y, route = best
        route = [Cigar(c.run_length * chunk_size, c.op) for c in route]
        if verbose:
            print(f"merging groups {x} and {y} at score {score} "
                  f"({len(groups)} groups left)")
        groups[x] = _merge_groups(groups[x], groups[y], route)
        groups[y] = groups[-1]
        groups.pop()
    return groups[0]


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
