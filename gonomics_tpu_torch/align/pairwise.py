"""Pairwise global alignment (gonomics ``align.ConstGap`` and
``align.AffineGap``): the counterpart of ``gonomics_tpu/align/pairwise.py``
(:1-247), with the same scores, cigars and tie-breaking.

The DP runs as one batch through ``ops/wavefront.wavefront_align`` on
``device`` (``None`` means the card; ``"cpu"`` runs the kernels' plain
PyTorch versions). In trace mode the trace comes to host memory in one
copy per batch, and each pair's cigar is walked there.
``affine_gap_lowmem`` runs the lowmem aligner instead, whose walk runs on
the device and returns only the ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import wavefront
from ..ops.wavefront import wavefront_align
from .cigar import COL_D, COL_I, COL_M, Cigar

_MAX_CODE = 4


def _check(seq: np.ndarray, name: str) -> np.ndarray:
    seq = np.asarray(seq, dtype=np.int8)
    if seq.size and seq.max() > _MAX_CODE:
        raise ValueError(
            f"{name} contains non-ACGTN bases; aligners accept codes 0..4 "
            "(gonomics would panic on these too, align.go:28)"
        )
    return seq


def _pad_batch(pairs, device):
    """Pad a list of (alpha, beta) to a common shape on ``device``:
    alpha (B, n) and beta (B, m) int8 padded with code 4, and fin (B,)
    int32 = n_b + m_b."""
    B = len(pairs)
    n = max(len(a) for a, _ in pairs)
    m = max(len(b) for _, b in pairs)
    alpha = np.full((B, n), 4, dtype=np.int8)
    beta = np.full((B, m), 4, dtype=np.int8)
    fin = np.zeros(B, dtype=np.int32)
    for i, (a, b) in enumerate(pairs):
        alpha[i, :len(a)] = a
        beta[i, :len(b)] = b
        fin[i] = len(a) + len(b)
    return (torch.from_numpy(alpha).to(device),
            torch.from_numpy(beta).to(device),
            torch.from_numpy(fin).to(device))


def _to_host(*tensors) -> list[np.ndarray]:
    """The batch's results in host memory, one copy each."""
    return [t.cpu().numpy() for t in tensors]


def _prio_k(m: int, i: int, d: int) -> int:
    if m >= i and m >= d:
        return 0
    return 1 if i >= d else 2


def _emit(route: list[Cigar], op: int, run: int = 1) -> None:
    """Add a run of ``op`` to a route being built backward."""
    if route and route[-1].op == op:
        route[-1].run_length += run
    else:
        route.append(Cigar(run, op))


def _close(route: list[Cigar], i: int, j: int) -> list[Cigar]:
    """Finish a backward walk that stopped at (i, 0) or (0, j): add the
    residual gap run and return the route in forward order."""
    if i > 0:
        _emit(route, COL_D, i)
    elif j > 0:
        _emit(route, COL_I, j)
    route.reverse()
    return route


def _walk_affine(trace: np.ndarray, b: int, n: int, m: int, k0: int):
    """Host traceback from the packed per-diagonal trace tensor.
    trace[d-1, b, s] packs (tM + 4*tI + 16*tD) for cell (i=s, j=d-s)."""
    route: list[Cigar] = []
    i, j, k = n, m, k0
    while i >= 1 and j >= 1:
        _emit(route, k)
        packed = int(trace[i + j - 1, b, i])
        if k == COL_M:
            k = packed & 3
            i, j = i - 1, j - 1
        elif k == COL_I:
            k = (packed >> 2) & 3
            j -= 1
        else:
            k = (packed >> 4) & 3
            i -= 1
    return _close(route, i, j)


def _walk_const(trace: np.ndarray, b: int, n: int, m: int):
    route: list[Cigar] = []
    i, j = n, m
    while i >= 1 and j >= 1:
        t = int(trace[i + j - 1, b, i])
        _emit(route, t)
        if t == COL_M:
            i, j = i - 1, j - 1
        elif t == COL_I:
            j -= 1
        else:
            i -= 1
    return _close(route, i, j)


def affine_gap_batch(pairs, scores, gap_open: int, gap_extend: int,
                     device=None, with_cigar: bool = True):
    """Batched AffineGap. pairs: list of (alpha, beta) int8 code arrays.
    Returns list of (score, route) — route None when with_cigar=False."""
    dev = resolve_device(device)
    pairs = [(_check(a, "alpha"), _check(b, "beta")) for a, b in pairs]
    alpha, beta, fin = _pad_batch(pairs, dev)
    if with_cigar:
        rm, ri, rd, trace = wavefront_align(
            alpha, beta, fin, scores, gap_open=gap_open,
            gap_extend=gap_extend, with_trace=True, mode="affine")
        rm, ri, rd, trace = _to_host(rm, ri, rd, trace)
        out = []
        for b, (a_seq, b_seq) in enumerate(pairs):
            nb, mb = len(a_seq), len(b_seq)
            fm, fi, fd = int(rm[b, nb]), int(ri[b, nb]), int(rd[b, nb])
            k0 = _prio_k(fm, fi, fd)
            score = (fm, fi, fd)[k0]
            out.append((score, _walk_affine(trace, b, nb, mb, k0)))
        return out
    res, = _to_host(wavefront_align(
        alpha, beta, fin, scores, gap_open=gap_open, gap_extend=gap_extend,
        with_trace=False, mode="affine"))
    return [(int(res[b, len(a)]), None) for b, (a, _) in enumerate(pairs)]


def const_gap_batch(pairs, scores, gap_pen: int, device=None,
                    with_cigar: bool = True):
    """Batched ConstGap; the same contract as ``affine_gap_batch``."""
    dev = resolve_device(device)
    pairs = [(_check(a, "alpha"), _check(b, "beta")) for a, b in pairs]
    alpha, beta, fin = _pad_batch(pairs, dev)
    if with_cigar:
        res, trace = wavefront_align(
            alpha, beta, fin, scores, gap_open=gap_pen, gap_extend=0,
            with_trace=True, mode="const")
        res, trace = _to_host(res, trace)
        return [(int(res[b, len(a)]), _walk_const(trace, b, len(a), len(bb)))
                for b, (a, bb) in enumerate(pairs)]
    res, = _to_host(wavefront_align(
        alpha, beta, fin, scores, gap_open=gap_pen, gap_extend=0,
        with_trace=False, mode="const"))
    return [(int(res[b, len(a)]), None) for b, (a, _) in enumerate(pairs)]


def affine_gap_lowmem(alpha, beta, scores, gap_open: int, gap_extend: int,
                      checkersize: int = 4096, device=None):
    """align.AffineGap_customizeCheckersize (affineGap.go:73): affine
    alignment of one pair too long for a full trace, through the lowmem
    aligner (``ops/wavefront.affine_gap_lowmem``: checkpoints every
    ``checkersize`` diagonals and a windowed re-fill per block), on
    ``device``. The same (score, route) contract as ``affine_gap``."""
    alpha = _check(alpha, "alpha")
    beta = _check(beta, "beta")
    score, ops_back, i0, j0 = wavefront.affine_gap_lowmem(
        alpha, beta, scores, gap_open, gap_extend, checkersize=checkersize,
        device=device)
    return score, lowmem_route(ops_back, i0, j0)


def lowmem_route(ops_back, i0: int, j0: int) -> list[Cigar]:
    """The cigar of a lowmem walk: its backward ops (0 M, 1 I, 2 D, from
    (n, m) toward the origin) and the residual gap run from where it
    stopped, (i0, 0) or (0, j0), in forward order."""
    route: list[Cigar] = []
    for op in ops_back:
        _emit(route, int(op))
    return _close(route, int(i0), int(j0))


def affine_gap(alpha, beta, scores, gap_open: int, gap_extend: int,
               device=None):
    """align.AffineGap (affineGap.go:60): single pair -> (score, route)."""
    return affine_gap_batch([(alpha, beta)], scores, gap_open, gap_extend,
                            device=device)[0]


def const_gap(alpha, beta, scores, gap_pen: int, device=None):
    """align.ConstGap (constGap.go:13): single pair -> (score, route)."""
    return const_gap_batch([(alpha, beta)], scores, gap_pen,
                           device=device)[0]
