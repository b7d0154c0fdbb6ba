"""Probabilistic DNA bases as (N, 4) float32 arrays: a copy of
``gonomics_tpu/pdna.py`` (84 lines, whole), gonomics' ``dna/pDna``.

A "base" is a length-4 probability vector [A, C, G, T]; gaps are all-zero
vectors, Ns are four equal non-zero entries (pDna.go:29-44). Every
predicate here runs over a whole sequence at once.
"""

from __future__ import annotations

import numpy as np

from . import dna
from .numbers.gomath import go_log2


def is_gap(seq: np.ndarray) -> np.ndarray:
    """pDna.IsGap: all four probabilities exactly zero."""
    return (np.asarray(seq) == 0).all(axis=-1)


def is_n(seq: np.ndarray) -> np.ndarray:
    """pDna.IsN: all four equal and non-zero."""
    s = np.asarray(seq)
    return ((s[..., 0] != 0) & (s[..., 0] == s[..., 1])
            & (s[..., 0] == s[..., 2]) & (s[..., 0] == s[..., 3]))


def is_confident(seq: np.ndarray, threshold: float) -> np.ndarray:
    """pDna.IsConfident: most likely base >= threshold (float32 compare)."""
    s = np.asarray(seq, np.float32)
    return s.max(axis=-1) >= np.float32(threshold)


def entropy(seq: np.ndarray) -> np.ndarray:
    """pDna.Entropy: Shannon entropy in bits, skipping zero entries.
    Uses the Go math.Log2 copy for last-ulp parity with goldens."""
    s = np.asarray(seq, np.float32).astype(np.float64)
    flat = s.reshape(-1, 4)
    out = np.zeros(len(flat), np.float64)
    for i, row in enumerate(flat):
        answer = 0.0
        for p in row:
            if p > 0:
                answer += -p * go_log2(p)
        out[i] = answer
    return out.reshape(s.shape[:-1])


def dot(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """pDna.Dot: float32 accumulation then widened (pDna.go:146)."""
    a = np.asarray(p, np.float32)
    b = np.asarray(q, np.float32)
    acc = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
           + a[..., 2] * b[..., 2] + a[..., 3] * b[..., 3])
    return acc.astype(np.float64)


def dot_subst_prob(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """pDna.DotSubstProb: 1 - dot product."""
    return 1.0 - dot(p, q)


def dist(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """pDna.Dist: Euclidean distance of the float32 difference."""
    d = (np.asarray(p, np.float32)
         - np.asarray(q, np.float32)).astype(np.float64)
    return np.sqrt((d * d).sum(axis=-1))


def dna_to_pdna(seq: np.ndarray) -> np.ndarray:
    """pDna.DnaToPdna over a sequence: one-hot for ACGT, 0.25s for N,
    zeros for Gap; errors on other codes."""
    s = np.asarray(seq)
    table = np.zeros((dna.NUM_BASES, 4), np.float32)
    for b, col in ((dna.A, 0), (dna.C, 1), (dna.G, 2), (dna.T, 3)):
        table[b, col] = 1.0
    table[dna.N] = 0.25
    ok = (s <= dna.N) | (s == dna.GAP)
    if not ok.all():
        raise ValueError("pDna.DnaToPdna encountered an inconvertible base")
    return table[s]
