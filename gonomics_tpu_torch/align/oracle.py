"""The numpy affine aligner on a substitution matrix: the part of
``gonomics_tpu/align/oracle.py`` that ``align/multi.all_seq_affine``
(and through it ``dunnIndex -realign``) runs, the same int64 steps and
tie order.

Copied: ``NEG``, ``_priority_argmax3`` and ``_scan_max_plus`` (:22-35),
``affine_gap_from_sub`` (:81-134), the reference's Gotoh DP
(affineGap.go:151-344) over a precomputed per-cell score matrix, and
the traceback ``_walk`` (:193-249). Scores are int64 like the
reference's; ties prefer M, then I, then D (tripleMaxTrace, align.go:78);
ColI consumes beta, ColD consumes alpha.
"""

from __future__ import annotations

import numpy as np

from .cigar import COL_D, COL_I, COL_M, Cigar

NEG = -(2 ** 62)  # veryNegNum analog; large enough to never win a max


def _priority_argmax3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """tripleMaxTrace tie order: M(0) >= I(1) >= D(2)."""
    return np.where((a >= b) & (a >= c), 0, np.where(b >= c, 1, 2)).astype(np.uint8)


def _scan_max_plus(c: np.ndarray, step: int) -> np.ndarray:
    """H[j] = max(c[j], H[j-1] + step) solved as a cumulative max."""
    j = np.arange(len(c), dtype=np.int64)
    shifted = c - j * step
    return np.maximum.accumulate(shifted) + j * step


def affine_gap_from_sub(sub: np.ndarray, gap_open: int, gap_extend: int):
    """Affine DP over a precomputed (n, m) per-cell substitution matrix —
    the form used by multipleAffineGap (group-column scores)."""
    n, m = sub.shape
    go_, ge = int(gap_open), int(gap_extend)

    tM = np.zeros((n, m), dtype=np.uint8)
    tI = np.zeros((n, m), dtype=np.uint8)
    tD = np.zeros((n, m), dtype=np.uint8)

    # Row 0 (affineGap.go:159-175): M[0][0]=0, I[0][0]=D[0][0]=gapOpen;
    # M[0][j]=NEG, I[0][j]=I[0][j-1]+ext, D[0][j]=NEG for j>0.
    j_idx = np.arange(m + 1, dtype=np.int64)
    Mp = np.full(m + 1, NEG, dtype=np.int64)
    Mp[0] = 0
    Ip = go_ + ge * j_idx
    Ip[0] = go_
    Dp = np.full(m + 1, NEG, dtype=np.int64)
    Dp[0] = go_

    for i in range(1, n + 1):
        s = sub[i - 1]
        # M[i][j] = s + max(Mp[j-1], Ip[j-1], Dp[j-1])
        Mc = np.empty(m + 1, dtype=np.int64)
        Mc[0] = NEG
        Mc[1:] = s + np.maximum(np.maximum(Mp[:-1], Ip[:-1]), Dp[:-1])
        tM[i - 1] = _priority_argmax3(Mp[:-1], Ip[:-1], Dp[:-1])

        # D[i][j] = max(go+ge+Mp[j], go+ge+Ip[j], ge+Dp[j])
        Dc = np.empty(m + 1, dtype=np.int64)
        Dc[0] = ge + Dp[0] if i > 0 else go_
        Dc[1:] = np.maximum(np.maximum(go_ + ge + Mp[1:], go_ + ge + Ip[1:]),
                            ge + Dp[1:])
        tD[i - 1] = _priority_argmax3(go_ + ge + Mp[1:], go_ + ge + Ip[1:],
                                      ge + Dp[1:])

        # I[i][j] = max(go+ge+Mc[j-1], ge+Ic[j-1], go+ge+Dc[j-1])
        # Mc, Dc of the current row are fully known; solve the I scan.
        c_in = go_ + ge + np.maximum(Mc[:-1], Dc[:-1])  # candidate openings
        seed = np.concatenate(([np.int64(NEG)], c_in))  # I[i][0] = NEG
        Ic = _scan_max_plus(seed, ge)
        aI = go_ + ge + Mc[:-1]
        bI = ge + Ic[:-1]
        cI = go_ + ge + Dc[:-1]
        tI[i - 1] = _priority_argmax3(aI, bI, cI)
        # Recompute Ic respecting exact tie order (scan gives max; equal).
        Mp, Ip, Dp = Mc, Ic, Dc

    finals = np.array([Mp[m], Ip[m], Dp[m]], dtype=np.int64)
    k0 = int(_priority_argmax3(finals[0:1], finals[1:2], finals[2:3])[0])
    score = int(finals[k0])
    route = _walk(tM, tI, tD, n, m, k0, affine=True)
    return score, route


def _walk(tM, tI, tD, n: int, m: int, k0: int, affine: bool = False):
    """Traceback walk. Replicates writeCigar + lastCigar semantics
    (constGap.go:186-252, affineGap.go:287-344): for affine, the op emitted
    at each step is the current state; the trace entry gives the
    predecessor state. After reaching row 0 or column 0, the remaining
    run is a single D (down column 0) or I (along row 0)."""
    route: list[Cigar] = []

    def emit(op: int) -> None:
        if route and route[-1].op == op:
            route[-1].run_length += 1
        else:
            route.append(Cigar(1, op))

    i, j = n, m
    if affine:
        k = k0
        while i >= 1 and j >= 1:
            emit(k)
            if k == COL_M:
                nk = int(tM[i - 1, j - 1])
                i, j = i - 1, j - 1
            elif k == COL_I:
                nk = int(tI[i - 1, j - 1])
                j -= 1
            else:
                nk = int(tD[i - 1, j - 1])
                i -= 1
            k = nk
    else:
        while i >= 1 and j >= 1:
            t = int(tM[i - 1, j - 1])
            emit(t)
            if t == COL_M:
                i, j = i - 1, j - 1
            elif t == COL_I:
                j -= 1
            else:
                i -= 1

    if i > 0:
        for _ in range(i):
            emit(COL_D)
    elif j > 0:
        for _ in range(j):
            emit(COL_I)

    route.reverse()
    # reversing flips run order; runs themselves are order-independent,
    # but adjacent equal ops may now be mergeable
    merged: list[Cigar] = []
    for c in route:
        if merged and merged[-1].op == c.op:
            merged[-1].run_length += c.run_length
        else:
            merged.append(c)
    return merged
