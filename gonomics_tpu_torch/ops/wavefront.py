"""Anti-diagonal wavefront DPs: batched pairwise global alignment (the
contract of ``wavefront_align``, ``gonomics_tpu/ops/wavefront.py:1534``,
for ``mode="affine"`` and ``mode="const"``, with and without trace), the
graph aligner's two extension DPs, the chromosome-scale lowmem aligner
(``affine_gap_lowmem_batch``, :1212-1303), and the score-only affine
entry points ``wavefront_affine_stream`` (:1449) and
``wavefront_align_blocked`` (:569).

Nine kernels, each with its plain PyTorch version beside it:

- ``trace_diag`` (CUDA ``csrc/wavefront.cu``, affine_score_diag's strips
  and pipeline with a trace step of its own, see ``trace_diag_plan``)
  replaces the Pallas kernel ``_affine_kernel`` (wavefront.py:94,
  ``pallas_call`` at :1584) in trace mode and ``_const_kernel`` (:243) in
  both modes; ``affine_wavefront(..., with_trace=True)`` and
  ``const_wavefront`` launch it;
- ``local_wavefront`` (CUDA ``csrc/gsw_dp.cu``, one warp a job, or one
  block a job past the warp's reach, see ``graph_dp_design``) replaces
  ``_local_kernel`` (:179, ``pallas_call`` :451 in ``wavefront_local``);
  ``local_align_full`` (:649, the read aligner's mesh path) runs it and
  the local side of ``ops.gsw_dp.gsw_walk_pack``;
- ``gsw_right_wavefront`` (same file) replaces ``_gsw_right_kernel``
  (:289, ``pallas_call`` :368 in ``wavefront_gsw_right``);
- ``affine_fwd_block`` (``csrc/wavefront.cu``, one thread-block cluster
  a pair, see ``fwd_block_plan``) replaces ``_affine_fwd_chunked_kernel``
  (:895, ``pallas_call`` :991);
- ``affine_bwd_window`` (same file) replaces ``_affine_bwd_window_kernel``
  (:1007, ``pallas_call`` :1085);
- ``lowmem_walk_block`` (same file) replaces the jnp walk ``_walk_block``
  (:1102);
- ``affine_stream`` (same file, one warp a pair, R rows a lane, see
  ``stream_plan``) replaces ``_affine_stream_kernel`` (:1306,
  ``pallas_call`` :1507 in ``wavefront_affine_stream``);
- ``affine_score_diag`` (same file, affine_stream's strips read out on
  each pair's diagonal fin, a pair's strips pipelined over warps, see
  ``score_diag_plan``) replaces ``_affine_kernel``'s score mode and
  ``_affine_block_kernel`` (:466, ``pallas_call`` :620 in
  ``wavefront_align_blocked``); ``affine_wavefront(..., with_trace=False)``
  and ``wavefront_align_blocked`` launch it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel, counts the launch in its module counter
(``trace_diag_launches``, ``local_launches``, ``gsw_right_launches``,
``affine_fwd_block_launches``, ``affine_bwd_window_launches``,
``lowmem_walk_launches``, ``affine_stream_launches``,
``affine_score_diag_launches``; ``affine_launches``, ``const_launches``
and ``affine_block_launches`` count the launches of affine_wavefront,
const_wavefront and wavefront_align_blocked, whichever kernel each
takes), and raises if the launch fails. It never falls back.

Layout: cell (i, j) lies on diagonal d = i + j at lane s = i, so results
are (B, S) int32 and the trace is (n+m, B, S) int8 with row d-1 holding
diagonal d, for S = n + 1 (the TPU's S, a multiple of 128 lanes, was its
lane quantum). Affine trace codes pack tM + 4 tI + 16 tD, each the
predecessor state in tie order M(0) > I(1) > D(2); const codes are that
argmax of (diag, left, up). Every interior cell (1 <= i <= n,
1 <= j <= m) holds the code the Pallas kernel writes there; row 0,
column 0 and the lanes outside the grid hold 0 (there the Pallas kernel
writes the argmax of its lane shift's junk, which no walk reads). On the
card the trace is a view of rows padded to ``trace_diag_launch_plan``'s
pitch (lane s at byte 15 + s), so its stride along B is that pitch. Each
pair's result is its diagonal n_b + m_b (``fin``), with every lane of
the grid on that diagonal; read lane n_b. A pair whose diagonal is never
reached keeps NEG. The graph kernels' layout and trace are described at
``local_wavefront_reference`` and ``gsw_right_wavefront_reference``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import NEG, resolve_device
from . import _kernels
from ._kernels import as_vec, expect

# Largest diagonal state (3 slots of (n+1) int32 lanes per state) that the
# lowmem forward and the graph DPs' block design keep in shared memory;
# above it they keep it in a global scratch. The card allows a block 227
# KB.
SMEM_STATE_BYTES_MAX = 200 * 1024
# int32 rows of n+1 lanes that each of them keeps per pair or job: three
# slots of each state, and for the graph DPs the per-lane bests (local:
# best value, its diagonal and the corner; anchored: best and diagonal)
_STATE_ROWS = {"affine": 9, "local": 6, "gsw_right": 5}
# Cluster sizes the lowmem kernels try, largest first (8 is the portable
# maximum of a thread-block cluster), and the fewest lanes a block of a
# cluster of affine_fwd_block keeps (below it a smaller cluster takes the
# pair).
CLUSTER_SIZES = (8, 7, 6, 5, 4, 3, 2, 1)
FWD_MIN_LANES = 1024

affine_launches = 0
const_launches = 0
local_launches = 0
gsw_right_launches = 0
affine_fwd_block_launches = 0
affine_bwd_window_launches = 0
lowmem_walk_launches = 0
affine_stream_launches = 0
affine_score_diag_launches = 0
affine_block_launches = 0
trace_diag_launches = 0


def state_in_shared_memory(n: int, mode: str) -> bool:
    """Whether the kernel for ``mode`` ("affine", the lowmem forward, or
    the graph DPs "local" and "gsw_right" in their block design) keeps the
    state of n + 1 lanes in shared memory rather than a global scratch
    (for the lowmem forward, n + 1 is the lanes a block sweeps, its
    chunk + 1)."""
    return _STATE_ROWS[mode] * (n + 1) * 4 <= SMEM_STATE_BYTES_MAX


def _max3(a, b, c):
    return torch.maximum(torch.maximum(a, b), c)


def _argmax3(a, b, c):
    """Tie order M(0) > I(1) > D(2) (``_argmax3``, wavefront.py:69)."""
    return torch.where((a >= b) & (a >= c), 0, torch.where(b >= c, 1, 2))


def _shift(x):
    """x[s] -> x[s-1] along lanes; lane 0 keeps its own value."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


class _Diagonals:
    """What the plain versions share: lane indices, and for each diagonal
    the substitution scores and the interior mask."""

    def __init__(self, alpha, beta, scores):
        B, n = alpha.shape
        m = beta.shape[1]
        dev = alpha.device
        self.n, self.m = n, m
        self.s = torch.arange(n + 1, device=dev)
        # alpha code per lane, clipped to 0..4; lane 0 reads 4
        al = torch.full((B, n + 1), 4, dtype=torch.int64, device=dev)
        al[:, 1:] = alpha.to(torch.int64).clamp(0, 4)
        # score row per beta code (_select_score, wavefront.py:85): 0 -> 0,
        # 1 or negative -> 1, 2 -> 2, 3 -> 3, 4 or more -> 4; column j
        # sits at j + n, and columns outside 1..m read 4
        be = beta.to(torch.int64)
        row = torch.where(be < 2, torch.where(be == 0, 0, 1), be.clamp(max=4))
        self.rows = torch.full((B, 2 * n + m + 1), 4, dtype=torch.int64,
                               device=dev)
        self.rows[:, n + 1:n + m + 1] = row
        self.al = al
        self.sc = torch.as_tensor(scores, dtype=torch.int32,
                                  device=dev).reshape(25)

    def sub(self, d: int, s=None):
        """Substitution score of cell (s, d - s): (B, S) over all lanes, or
        over the lanes s (B, W) of a window. Beyond diagonal n + m (the
        lowmem forward's last block) the column index is clamped; those
        cells lie outside the grid, where every caller masks the score."""
        if s is None:
            idx = (d + self.n - self.s).clamp(max=self.rows.shape[1] - 1)
            return self.sc[self.rows[:, idx] * 5 + self.al]
        idx = (d + self.n - s).clamp(max=self.rows.shape[1] - 1)
        return self.sc[self.rows.gather(1, idx) * 5 + self.al.gather(1, s)]

    def interior(self, d: int, s=None):
        s = self.s if s is None else s
        return (s >= max(1, d - self.m)) & (s <= min(d - 1, self.n))


def _neg(B: int, S: int, device) -> torch.Tensor:
    return torch.full((B, S), NEG, dtype=torch.int32, device=device)


def _edge(mask, value: int) -> torch.Tensor:
    """int32 ``value`` where ``mask``, NEG elsewhere."""
    return torch.where(mask, value, NEG).to(torch.int32)


def affine_wavefront_reference(alpha, beta, fin, scores, gap_open: int,
                               gap_extend: int, with_trace: bool):
    """Plain PyTorch global Gotoh alignment, one diagonal at a time over
    (B, S) tensors: the arithmetic of ``_affine_kernel``
    (wavefront.py:94-176).

    alpha (B, n), beta (B, m) int8 codes; fin (B,) or (B, 1) int32; scores
    (5, 5). Trace mode returns (rm, ri, rd, trace): M, I and D of each
    pair's diagonal fin_b, (B, S) int32, and the (n+m, B, S) int8 trace;
    score mode returns res, max3(M, I, D) at fin_b."""
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    go, ge = int(gap_open), int(gap_extend)
    goe = go + ge
    dg = _Diagonals(alpha, beta, scores)
    fin = as_vec(fin, B, dev)[:, None]
    # diagonal 0: cell (0,0) has M = 0 and I = D = go (affineGap.go:159-165)
    m1, i1, d1 = _neg(B, S, dev), _neg(B, S, dev), _neg(B, S, dev)
    m1[:, 0], i1[:, 0], d1[:, 0] = 0, go, go
    m2, i2, d2 = _neg(B, S, dev), _neg(B, S, dev), _neg(B, S, dev)
    rm, ri, rd = _neg(B, S, dev), _neg(B, S, dev), _neg(B, S, dev)
    trace = (torch.empty((n + m, B, S), dtype=torch.int8, device=dev)
             if with_trace else None)
    for d in range(1, n + m + 1):
        # M from (d-2, s-1), I from (d-1, s), D from (d-1, s-1)
        m_new = dg.sub(d) + _shift(_max3(m2, i2, d2))
        a_i, b_i, c_i = goe + m1, ge + i1, goe + d1
        i_new = _max3(a_i, b_i, c_i)
        b_d, c_d = goe + i1, ge + d1
        d_new = _shift(_max3(a_i, b_d, c_d))
        interior = dg.interior(d)
        if with_trace:
            code = (_shift(_argmax3(m2, i2, d2)) + 4 * _argmax3(a_i, b_i, c_i)
                    + 16 * _shift(_argmax3(a_i, b_d, c_d)))
            trace[d - 1] = torch.where(interior, code, 0).to(torch.int8)
        bnd = go + ge * d
        row0 = (dg.s == 0) & (d <= m)       # cell (0, d)
        col0 = (dg.s == d) & (d <= n)       # cell (d, 0)
        m_new = torch.where(interior, m_new, NEG)
        i_new = torch.where(interior, i_new, _edge(row0, bnd))
        d_new = torch.where(interior, d_new, _edge(col0, bnd))
        at = fin == d
        if with_trace:
            rm = torch.where(at, m_new, rm)
            ri = torch.where(at, i_new, ri)
            rd = torch.where(at, d_new, rd)
        else:
            rm = torch.where(at, _max3(m_new, i_new, d_new), rm)
        m2, i2, d2 = m1, i1, d1
        m1, i1, d1 = m_new, i_new, d_new
    return (rm, ri, rd, trace) if with_trace else rm


def const_wavefront_reference(alpha, beta, fin, scores, gap: int,
                              with_trace: bool):
    """Plain PyTorch global linear-gap alignment, one diagonal at a time
    over (B, S) tensors: the arithmetic of ``_const_kernel``
    (wavefront.py:243-286). Inputs as ``affine_wavefront_reference``;
    returns (res, trace) in trace mode and res in score mode, res being
    each pair's score on its diagonal fin_b."""
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    gap = int(gap)
    dg = _Diagonals(alpha, beta, scores)
    fin = as_vec(fin, B, dev)[:, None]
    c1 = _neg(B, S, dev)
    c1[:, 0] = 0
    c2 = _neg(B, S, dev)
    res = _neg(B, S, dev)
    trace = (torch.empty((n + m, B, S), dtype=torch.int8, device=dev)
             if with_trace else None)
    for d in range(1, n + m + 1):
        diag = _shift(c2) + dg.sub(d)   # from (i-1, j-1): M
        left = c1 + gap                 # from (i, j-1): I
        up = _shift(c1) + gap           # from (i-1, j): D
        if with_trace:
            trace[d - 1] = torch.where(dg.interior(d),
                                       _argmax3(diag, left, up),
                                       0).to(torch.int8)
        edge = (((dg.s == 0) & (d <= m)) | ((dg.s == d) & (d <= n)))
        c = torch.where(dg.interior(d), _max3(diag, left, up),
                        _edge(edge, gap * d))
        res = torch.where(fin == d, c, res)
        c2, c1 = c1, c
    return (res, trace) if with_trace else res


def local_wavefront_reference(alpha, beta, n_vec, m_vec, scores, gap: int,
                              with_corner: bool = False):
    """Plain PyTorch local (Smith-Waterman) linear-gap DP, one diagonal at
    a time over (C, S) tensors: the arithmetic of ``_local_kernel``
    (wavefront.py:179-240), LeftDynamicAln of the graph aligner.

    alpha (C, n) int8 (the genome windows), beta (C, m) int8 (the read
    parts), n_vec / m_vec (C,) int32 each job's own lengths n_b, m_b;
    scores (5, 5). Cell c = max(diag + sub, left + gap, up + gap) inside
    1 <= i <= n_b, 1 <= j <= m_b, and 0 outside or where it is <= 0. The
    trace (n+m, C, S) int8 holds 3 where c == 0, else the argmax in the
    order diag (0) > left (1) > up (2), on every lane. bv, bd (C, S)
    int32 keep each lane's best c and its diagonal by strict >, from 0.
    Returns (bv, bd, trace), and with ``with_corner`` also corner (C, S):
    each lane's c on diagonal n_b + m_b, so lane n_b holds cell
    (n_b, m_b)."""
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    gap = int(gap)
    dg = _Diagonals(alpha, beta, scores)
    nb = as_vec(n_vec, C, dev)[:, None]
    mb = as_vec(m_vec, C, dev)[:, None]
    zeros = torch.zeros((C, S), dtype=torch.int32, device=dev)
    c1 = c2 = bv = bd = corner = zeros
    trace = torch.empty((n + m, C, S), dtype=torch.int8, device=dev)
    for d in range(1, n + m + 1):
        diag = _shift(c2) + dg.sub(d)
        left = c1 + gap
        up = _shift(c1) + gap
        j = d - dg.s
        inside = (dg.s >= 1) & (dg.s <= nb) & (j >= 1) & (j <= mb)
        c = _max3(diag, left, up)
        c = torch.where(inside & (c > 0), c, 0).to(torch.int32)
        trace[d - 1] = torch.where(c == 0, 3,
                                   _argmax3(diag, left, up)).to(torch.int8)
        upd = inside & (c > bv)
        bd = torch.where(upd, d, bd).to(torch.int32)
        bv = torch.where(upd, c, bv)
        if with_corner:
            corner = torch.where(nb + mb == d, c, corner)
        c2, c1 = c1, c
    return (bv, bd, trace, corner) if with_corner else (bv, bd, trace)


def gsw_right_wavefront_reference(alpha, beta, n_vec, m_vec, scores,
                                  gap: int):
    """Plain PyTorch prefix-anchored linear-gap DP, one diagonal at a time
    over (C, S) tensors: the arithmetic of ``_gsw_right_kernel``
    (wavefront.py:289-343), RightDynamicAln of the graph aligner.

    Inputs as ``local_wavefront_reference``. Unclamped over the padded
    grid: row 0 and column 0 hold gap * d with trace codes 1 and 2, the
    interior max(diag + sub, left + gap, up + gap) with the argmax code
    (diag 0 > left 1 > up 2). bv, bd (C, S) int32 keep each lane's best
    cell inside the job's own 1 <= i <= n_b, 1 <= j <= m_b by strict >,
    from 0. Returns (bv, bd, trace); trace codes outside row 0, column 0
    and the interior are 0 (there the Pallas kernel writes the argmax of
    its lane shift's junk, which no walk reads)."""
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    gap = int(gap)
    dg = _Diagonals(alpha, beta, scores)
    nb = as_vec(n_vec, C, dev)[:, None]
    mb = as_vec(m_vec, C, dev)[:, None]
    c1 = _neg(C, S, dev)
    c1[:, 0] = 0
    c2 = _neg(C, S, dev)
    bv = bd = torch.zeros((C, S), dtype=torch.int32, device=dev)
    trace = torch.empty((n + m, C, S), dtype=torch.int8, device=dev)
    for d in range(1, n + m + 1):
        diag = _shift(c2) + dg.sub(d)
        left = c1 + gap
        up = _shift(c1) + gap
        interior = dg.interior(d)
        row0 = (dg.s == 0) & (d <= m)
        col0 = (dg.s == d) & (d <= n)
        c = torch.where(interior, _max3(diag, left, up),
                        _edge(row0 | col0, gap * d)).to(torch.int32)
        edge_code = torch.where(row0, 1, torch.where(col0, 2, 0))
        trace[d - 1] = torch.where(interior, _argmax3(diag, left, up),
                                   edge_code).to(torch.int8)
        j = d - dg.s
        inside = (dg.s >= 1) & (dg.s <= nb) & (j >= 1) & (j <= mb)
        upd = inside & (c > bv)
        bd = torch.where(upd, d, bd).to(torch.int32)
        bv = torch.where(upd, c, bv)
        c2, c1 = c1, c
    return bv, bd, trace


def _launch_inputs(alpha, beta, fin, scores):
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    return (expect(alpha, torch.int8, (B, n), "alpha", dev),
            expect(beta, torch.int8, (B, m), "beta", dev),
            expect(as_vec(fin, B, dev), torch.int32, (B,), "fin", dev),
            expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                   torch.int32, (5, 5), "scores", dev))


def _ptr(t):
    return None if t is None else t.data_ptr()


def affine_wavefront(alpha, beta, fin, scores, gap_open: int,
                     gap_extend: int, with_trace: bool):
    """Global affine wavefront (see ``affine_wavefront_reference``): the
    plain version for CPU tensors; for CUDA tensors the CUDA kernel
    trace_diag in trace mode (``trace_diag_plan``), affine_score_diag (its
    one row block of n rows, ``score_diag_plan``) in score mode."""
    global affine_launches
    if alpha.device.type == "cpu":
        return affine_wavefront_reference(alpha, beta, fin, scores, gap_open,
                                          gap_extend, with_trace)
    alpha, beta, fin, sc = _launch_inputs(alpha, beta, fin, scores)
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    if not with_trace:
        res = torch.empty((B, S), dtype=torch.int32, device=dev)
        if B:
            _score_diag_launch(alpha, beta, fin, sc, gap_open, gap_extend, n,
                               n, 1, score_diag_launch_plan(B, n, m), res)
            affine_launches += 1
        return res
    rm, ri, rd = (torch.empty((B, S), dtype=torch.int32, device=dev)
                  for _ in range(3))
    if B == 0:
        return rm, ri, rd, torch.empty((n + m, 0, S), dtype=torch.int8,
                                       device=dev)
    trace = _trace_diag_launch("affine", alpha, beta, fin, sc, gap_open,
                               gap_extend,
                               trace_diag_launch_plan(B, n, m, "affine"),
                               (rm, ri, rd))
    affine_launches += 1
    return rm, ri, rd, trace


def const_wavefront(alpha, beta, fin, scores, gap: int, with_trace: bool):
    """Global linear-gap wavefront (see ``const_wavefront_reference``):
    the plain version for CPU tensors, the CUDA kernel trace_diag
    (``trace_diag_plan``) for CUDA tensors."""
    global const_launches
    if alpha.device.type == "cpu":
        return const_wavefront_reference(alpha, beta, fin, scores, gap,
                                         with_trace)
    alpha, beta, fin, sc = _launch_inputs(alpha, beta, fin, scores)
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    res = torch.empty((B, n + 1), dtype=torch.int32, device=dev)
    mode = "const" if with_trace else "const_score"
    if B == 0:
        trace = (torch.empty((n + m, 0, n + 1), dtype=torch.int8, device=dev)
                 if with_trace else None)
    else:
        trace = _trace_diag_launch(mode, alpha, beta, fin, sc, gap, 0,
                                   trace_diag_launch_plan(B, n, m, mode),
                                   (res,))
        const_launches += 1
    return (res, trace) if with_trace else res


def _graph_inputs(alpha, beta, n_vec, m_vec, scores):
    """The graph kernels' checked inputs."""
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    return (expect(alpha, torch.int8, (C, n), "alpha", dev),
            expect(beta, torch.int8, (C, m), "beta", dev),
            expect(as_vec(n_vec, C, dev), torch.int32, (C,), "n_vec", dev),
            expect(as_vec(m_vec, C, dev), torch.int32, (C,), "m_vec", dev),
            expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                   torch.int32, (5, 5), "scores", dev))


_graph_configs: dict = {}


def _graph_built() -> dict:
    """What the graph DPs' warp design is built for, as the kernels'
    library reports it: the slots a lane it takes (32 L slots a warp),
    rising."""
    if "built" not in _graph_configs:
        out = (ctypes.c_int * 16)()
        lib = _kernels.lib("gsw_dp")
        _kernels.check(lib.gsw_dp_built(ctypes.addressof(out)),
                       "local_wavefront")
        _graph_configs["built"] = {"slots": tuple(out[2:2 + out[1]])}
    return _graph_configs["built"]


def graph_dp_design(n: int, m: int, mode: str, built: dict) -> dict:
    """How local_wavefront ("local") or gsw_right_wavefront ("gsw_right")
    runs jobs padded to (n, m), chosen by shape alone from what the warp
    design is ``built`` for (``_graph_built``). The warp design (one warp
    a job, no block barrier, the state along the read part in registers,
    the trace filled with its constant before the warps write their
    cells) wherever its m + 1 slots fit the slots a lane it is built for:
    ``slots_per_lane`` is the smallest L with 32 L >= m + 1. Beyond it the
    block design (one block a job, a barrier a diagonal), its state in
    shared memory or a global scratch as ``state_in_shared_memory``
    says."""
    if mode not in ("local", "gsw_right"):
        raise ValueError(f"unknown graph DP mode {mode!r}")
    L = next((r for r in built["slots"] if 32 * r >= m + 1), 0)
    if L:
        return {"design": "warp", "slots_per_lane": L, "state": "registers"}
    return {"design": "block", "slots_per_lane": 0,
            "state": ("shared" if state_in_shared_memory(n, mode)
                      else "global")}


def graph_dp_plan(C: int, n: int, m: int, mode: str) -> dict:
    """``graph_dp_design`` for C jobs padded to (n, m) from the card's
    library, with the launch it makes as the library reports it: a
    block's threads and warps, and the blocks."""
    plan = graph_dp_design(n, m, mode, _graph_built())
    out = (ctypes.c_int * 2)()
    lib = _kernels.lib("gsw_dp")
    _kernels.check(lib.gsw_dp_launch_shape(C, n, plan["slots_per_lane"],
                                           ctypes.addressof(out)),
                   "local_wavefront")
    return {**plan, "threads": out[0], "warps_per_block": out[0] // 32,
            "blocks": out[1]}


def local_wavefront(alpha, beta, n_vec, m_vec, scores, gap: int,
                    with_corner: bool = False):
    """Local linear-gap DP of the graph aligner's left extension (see
    ``local_wavefront_reference``): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, as ``graph_dp_design`` picks it."""
    if alpha.device.type == "cpu":
        return local_wavefront_reference(alpha, beta, n_vec, m_vec, scores,
                                         gap, with_corner)
    args = _graph_inputs(alpha, beta, n_vec, m_vec, scores)
    plan = graph_dp_design(args[0].shape[1], args[1].shape[1], "local",
                           _graph_built())
    return _graph_launch("local", *args, gap, with_corner, plan)


def gsw_right_wavefront(alpha, beta, n_vec, m_vec, scores, gap: int):
    """Prefix-anchored linear-gap DP of the graph aligner's right
    extension (see ``gsw_right_wavefront_reference``): the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors, as
    ``graph_dp_design`` picks it."""
    if alpha.device.type == "cpu":
        return gsw_right_wavefront_reference(alpha, beta, n_vec, m_vec,
                                             scores, gap)
    args = _graph_inputs(alpha, beta, n_vec, m_vec, scores)
    plan = graph_dp_design(args[0].shape[1], args[1].shape[1], "gsw_right",
                           _graph_built())
    return _graph_launch("gsw_right", *args, gap, False, plan)


def _split_local_rows(rows: torch.Tensor):
    """(score, i_end, j_end, i0, j0, packed) of the local walk's (B, 20 +
    P) rows: five (B,) int32 from the little-endian meta and the packed
    ops (B, P) uint8."""
    meta = torch.empty((rows.shape[0], 20), dtype=torch.uint8,
                       device=rows.device)
    meta.copy_(rows[:, :20])  # a fresh row-major copy, also for B = 0
    return (*meta.view(torch.int32).T.contiguous(),
            rows[:, 20:].contiguous())


def local_align_full_reference(alpha, beta, n_vec, m_vec, scores, gap: int):
    """Plain ``local_align_full``: ``local_wavefront_reference`` and the
    local side of ``gsw_walk_pack_reference``."""
    from .gsw_dp import gsw_walk_pack_reference  # gsw_dp imports this module

    bv, bd, trace = local_wavefront_reference(alpha, beta, n_vec, m_vec,
                                              scores, gap)
    return _split_local_rows(gsw_walk_pack_reference("local", trace, bv, bd))


def local_align_full(alpha, beta, n_vec, m_vec, scores, gap: int):
    """Batched local alignment with its traceback on the device, the
    contract of ``local_align_full`` (wavefront.py:649-697), the read
    aligner's mesh path: K4 over each pair's whole grid (alpha (B, n) the
    reads, beta (B, m) the windows, n_vec / m_vec (B,) their lengths);
    score = the max of bv over the lanes, its first lane s* (jnp.argmax),
    i_end = s*, j_end = bd[s*] - s*; then a walk of D = n + m steps from
    (i_end, j_end) while score > 0, stopping on code 3 or at i = 0 or j =
    0, ops 0 M, 1 left (j - 1), 2 up (i - 1), 4 once inactive, packed as
    min(op, 3) four to a byte, low bits first, padded with 3. Returns
    score, i_end, j_end, i0, j0 (B,) int32 and packed (B, ceil(D / 4))
    uint8. Runs where ``alpha`` lies: the plain version on the CPU; on the
    card ``local_wavefront`` and the local side of ``gsw_walk_pack``, two
    launches, the trace ((n + m) (n + 1) bytes a pair) never leaving the
    card."""
    if alpha.device.type == "cpu":
        return local_align_full_reference(alpha, beta, n_vec, m_vec, scores,
                                          gap)
    from .gsw_dp import gsw_walk_pack  # gsw_dp imports this module

    bv, bd, trace = local_wavefront(alpha, beta, n_vec, m_vec, scores, gap)
    return _split_local_rows(gsw_walk_pack("local", trace, bv, bd))


def _graph_launch(mode: str, alpha, beta, n_vec, m_vec, sc, gap: int,
                  with_corner: bool, plan: dict):
    """Launch local_wavefront ("local") or gsw_right_wavefront
    ("gsw_right") on checked CUDA inputs with ``plan`` (the wrappers take
    ``graph_dp_design``'s; the card tests and tools/graph_timing.py force
    the design and the slots a lane). Returns the wrapper's outputs."""
    global local_launches, gsw_right_launches
    local = mode == "local"
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    bv = torch.empty((C, S), dtype=torch.int32, device=dev)
    bd = torch.empty((C, S), dtype=torch.int32, device=dev)
    corner = (torch.empty((C, S), dtype=torch.int32, device=dev)
              if with_corner else None)
    trace = torch.empty((n + m, C, S), dtype=torch.int8, device=dev)
    out = ((bv, bd, trace, corner) if with_corner else (bv, bd, trace))
    if C == 0:
        return out
    scratch = (torch.empty((C, _STATE_ROWS[mode] * S), dtype=torch.int32,
                           device=dev)
               if plan["design"] == "block" and plan["state"] == "global"
               else None)
    slots = plan["slots_per_lane"] if plan["design"] == "warp" else 0
    lib = _kernels.lib("gsw_dp")
    name = "local_wavefront" if local else "gsw_right_wavefront"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        common = (alpha.data_ptr(), beta.data_ptr(), n_vec.data_ptr(),
                  m_vec.data_ptr(), sc.data_ptr(), int(gap), C, n, m, slots,
                  _ptr(scratch), bv.data_ptr(), bd.data_ptr())
        if local:
            rc = lib.local_wavefront_launch(*common, _ptr(corner),
                                            trace.data_ptr(), stream)
        else:
            rc = lib.gsw_right_wavefront_launch(*common, trace.data_ptr(),
                                                stream)
    _kernels.check(rc, name)
    if local:
        local_launches += 1
    else:
        gsw_right_launches += 1
    return out


def wavefront_align(alpha_pad, beta_pad, fin_d, scores, *, gap_open: int,
                    gap_extend: int, with_trace: bool, mode: str = "affine"):
    """Run the wavefront DP over a batch of padded pairs, where the
    tensors lie (the contract of ``wavefront_align``, wavefront.py:1534;
    n and m are the padded widths of alpha_pad and beta_pad).

    alpha_pad (B, n) int8 codes, beta_pad (B, m) int8, fin_d (B,) or
    (B, 1) int32 = n_b + m_b per pair. Affine: trace mode returns
    (rm, ri, rd, trace), score mode res. Const (gap_open is the gap,
    gap_extend is unused): trace mode (res, trace), score mode res.
    res/rm/ri/rd are (B, n+1) int32, trace (n+m, B, n+1) int8."""
    if mode == "affine":
        return affine_wavefront(alpha_pad, beta_pad, fin_d, scores, gap_open,
                                gap_extend, with_trace)
    if mode == "const":
        return const_wavefront(alpha_pad, beta_pad, fin_d, scores, gap_open,
                               with_trace)
    raise ValueError(f"unknown wavefront mode {mode!r}")


# ---------------------------------------------------------------------------
# Score-only global affine alignment: the streamed entry point (P x B pairs
# of one shape, the score at cell (n, m)) and the row-blocked one (the
# score-mode DP in blocks of r_rows rows, read out per block). Both compute
# what K2's score mode computes; the row-blocked one and K2's score mode
# run one kernel, affine_score_diag.


def _tensor(x, dtype, device) -> torch.Tensor:
    """x itself when it is a tensor (used where it lies), else x as a
    tensor on ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(resolve_device(device))


def affine_stream_reference(alpha, beta, scores, gap_open: int,
                            gap_extend: int):
    """Plain PyTorch global affine score of P x B pairs of one shape: lane
    n of ``affine_wavefront_reference``'s score mode at fin = n + m, over
    the pairs flattened to P·B rows (the function of
    ``_affine_stream_kernel``, wavefront.py:1306, whose odd pad column of
    beta never feeds cell (n, m)). alpha (P, B, n), beta (P, B, m) int8;
    returns (P, B) int32."""
    P, B, n = alpha.shape
    m = beta.shape[2]
    fin = torch.full((P * B,), n + m, dtype=torch.int32, device=alpha.device)
    res = affine_wavefront_reference(alpha.reshape(P * B, n),
                                     beta.reshape(P * B, m), fin, scores,
                                     gap_open, gap_extend, False)
    return res[:, n].reshape(P, B)


# Rows a lane of affine_stream at the main shape (bench.py's 8 x 256 pairs
# of 1024 x 1024), the fastest of the built counts there (PERF.md §6,
# tools/score_timing.py plans).
STREAM_ROWS_PER_LANE = 8

_stream_configs: dict = {}


def _stream_built() -> dict:
    """What affine_stream is built for, as the kernels' library reports
    it: the pairs (warps) a block and the rows a lane it takes, rising."""
    if "built" not in _stream_configs:
        out = (ctypes.c_int * 16)()
        lib = _kernels.lib("wavefront")
        _kernels.check(lib.affine_stream_built(ctypes.addressof(out)),
                       "affine_stream")
        _stream_configs["built"] = {"warps_per_block": out[0],
                                    "rows_per_lane": tuple(out[2:2 + out[1]])}
    return _stream_configs["built"]


def stream_plan(n: int, m: int, built: dict,
                main: int = STREAM_ROWS_PER_LANE) -> dict:
    """The rows a lane R with which affine_stream runs pairs of n x m,
    chosen by shape alone from the counts it is ``built`` for
    (``_stream_built``): the smallest R whose strip of 32 R rows holds
    all n rows, where that is below ``main`` (``STREAM_ROWS_PER_LANE``;
    the other kernels of R rows a lane pass their own), else ``main``
    (strips of 32 of its rows), which must be built."""
    rows = built["rows_per_lane"]
    if main not in rows:
        raise ValueError(f"kernel not built for {main} rows a lane")
    return _strips(next((r for r in rows if 32 * r >= n and r < main), main),
                   n, m)


def _strips(R: int, n: int, m: int) -> dict:
    return {"rows_per_lane": R, "strip_rows": 32 * R,
            "strips": -(-n // (32 * R)), "steps_a_strip": m + 32 * R - 1}


def stream_launch_plan(P: int, n: int, m: int, R: int | None = None) -> dict:
    """``stream_plan`` for P pairs of n x m (or the forced rows a lane R)
    with the launch the card's library makes of it: a block's threads and
    warps, the blocks, the boundary row's columns a pair, a thread's
    registers and spilled bytes, a block's static shared memory and the
    blocks an SM holds."""
    key = (P, n, m, R)
    if key not in _stream_configs:
        plan = (stream_plan(n, m, _stream_built()) if R is None
                else _strips(R, n, m))
        out = (ctypes.c_int * 7)()
        lib = _kernels.lib("wavefront")
        _kernels.check(lib.affine_stream_shape(P, m, plan["rows_per_lane"],
                                               ctypes.addressof(out)),
                       "affine_stream")
        _stream_configs[key] = {
            **plan, "threads": out[0], "warps_per_block": out[0] // 32,
            "blocks": out[1], "boundary_columns": out[2],
            "registers": out[3], "spill_bytes": out[4],
            "smem_bytes_per_block": out[5], "blocks_per_sm": out[6]}
    return _stream_configs[key]


def wavefront_affine_stream(alpha, beta, scores, *, n: int, m: int,
                            gap_open: int, gap_extend: int, device=None):
    """Score-only global affine alignment of P x B pairs of one shape (the
    contract of ``wavefront_affine_stream``, wavefront.py:1449): alpha
    (P, B, n), beta (P, B, m) int8 codes with P even and m >= n, as the
    JAX function requires. Returns the (P, B) int32 scores of cell
    (n, m), where the tensors lie; numpy inputs go to ``device`` (None is
    the card). CPU tensors take ``affine_stream_reference``, CUDA tensors
    the CUDA kernel ``affine_stream`` (one warp a pair, ``stream_plan``'s
    rows a lane)."""
    alpha = _tensor(alpha, torch.int8, device)
    dev = alpha.device
    beta = _tensor(beta, torch.int8, dev)
    P, B = alpha.shape[:2]
    if P % 2:
        raise ValueError("stream kernel needs an even pair count P")
    if m < n:
        raise ValueError("stream kernel needs m >= n (swap operands)")
    alpha = expect(alpha, torch.int8, (P, B, n), "alpha", dev)
    beta = expect(beta, torch.int8, (P, B, m), "beta", dev)
    sc = expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                torch.int32, (5, 5), "scores", dev)
    if dev.type == "cpu":
        return affine_stream_reference(alpha, beta, sc, gap_open, gap_extend)
    out = torch.empty((P, B), dtype=torch.int32, device=dev)
    if P * B == 0:
        return out
    return _stream_launch(alpha, beta, sc, gap_open, gap_extend,
                          stream_launch_plan(P * B, n, m), out)


def _stream_launch(alpha, beta, sc, gap_open: int, gap_extend: int,
                   plan: dict, out):
    """Launch affine_stream on checked CUDA inputs with ``plan``
    (``stream_launch_plan``) into out, (P, B) int32."""
    global affine_stream_launches
    dev = alpha.device
    P, B, n = alpha.shape
    m = beta.shape[2]
    # per pair, the last row of the strip before: max(M, I), D a column
    bnd = torch.empty((P * B, plan["boundary_columns"], 2), dtype=torch.int32,
                      device=dev)
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_stream_launch(
            alpha.data_ptr(), beta.data_ptr(), sc.data_ptr(), int(gap_open),
            int(gap_extend), P * B, n, m, plan["rows_per_lane"],
            bnd.data_ptr(), out.data_ptr(), stream)
    _kernels.check(rc, "affine_stream")
    affine_stream_launches += 1
    return out


# Warps that fill the card with affine_stream's step at R = 8: 4 a
# scheduler, at 128 registers a thread (PERF.md §6). A launch of
# affine_score_diag with fewer pairs gives each pair more warps.
SCORE_DIAG_FILL_WARPS = 2048


def _diag_built(kernel: str, *mode: int) -> dict:
    """What ``kernel`` (affine_score_diag, or trace_diag in one mode) is
    built for, as the kernels' library reports it: the most warps a block
    (and a pair) has, the warps a block takes at one warp a pair, and the
    rows a lane it takes, rising."""
    key = (kernel, "built", *mode)
    if key not in _stream_configs:
        out = (ctypes.c_int * 16)()
        lib = _kernels.lib("wavefront")
        _kernels.check(getattr(lib, kernel + "_built")(
            *mode, ctypes.addressof(out)), kernel)
        _stream_configs[key] = {
            "max_warps": out[0], "pair_warps": out[1],
            "rows_per_lane": tuple(out[3:3 + out[2]])}
    return _stream_configs[key]


def _score_diag_built() -> dict:
    """``_diag_built`` of affine_score_diag."""
    return _diag_built("affine_score_diag")


def _diag_block(B: int, W: int, built: dict) -> dict:
    """The block shape of affine_score_diag at W warps a pair: one
    pair's W warps, or built["pair_warps"] // W pairs of W warps where W is
    smaller; and the blocks B pairs take."""
    per = built["pair_warps"]
    warps = W if W >= per else per // W * W
    return {"warps_per_pair": W, "warps_per_block": warps,
            "pairs_per_block": warps // W, "blocks": -(-B // (warps // W))}


def score_diag_plan(B: int, rows: int, m: int, built: dict) -> dict:
    """How affine_score_diag runs B pairs of rows x m, chosen by shape
    alone from what it is ``built`` for (``_score_diag_built``): R rows a
    lane as ``stream_plan`` picks it for rows rows, and W warps a pair as
    ``_diag_plan`` picks them."""
    return _diag_plan(B, stream_plan(rows, m, built)["rows_per_lane"], rows,
                      m, built)


def _diag_plan(B: int, R: int, rows: int, m: int, built: dict) -> dict:
    """The strips of R rows a lane of B pairs of rows x m and W warps a
    pair: 1 where the B pairs alone fill the card (SCORE_DIAG_FILL_WARPS
    of them), else the fewest that fill it with B W warps, at most the
    pair's strips and the warps a block holds (``_diag_block`` gives the
    block)."""
    plan = _strips(R, rows, m)
    fill = -(-SCORE_DIAG_FILL_WARPS // max(B, 1))
    W = max(1, min(plan["strips"], built["max_warps"], fill))
    return {**plan, **_diag_block(B, W, built)}


def score_diag_launch_plan(B: int, rows: int, m: int, R: int | None = None,
                           W: int | None = None) -> dict:
    """``score_diag_plan`` for B pairs of rows x m (or the forced rows a
    lane R and warps a pair W) with the launch the card's library makes
    of it: a block's threads, the blocks, the int2 columns of a ring row,
    a thread's registers and spilled bytes, a block's shared memory and
    the blocks an SM holds."""
    key = ("diag", B, rows, m, R, W)
    if key not in _stream_configs:
        built = _score_diag_built()
        plan = score_diag_plan(B, rows, m, built)
        if R is not None or W is not None:
            R = plan["rows_per_lane"] if R is None else R
            plan = {**_strips(R, rows, m),
                    **_diag_block(B, plan["warps_per_pair"] if W is None
                                  else W, built)}
        out = (ctypes.c_int * 7)()
        lib = _kernels.lib("wavefront")
        _kernels.check(lib.affine_score_diag_shape(
            B, m, plan["rows_per_lane"], plan["warps_per_pair"],
            ctypes.addressof(out)), "affine_score_diag")
        _stream_configs[key] = {
            **plan, "threads": out[0], "launch_blocks": out[1],
            "ring_columns": out[2], "registers": out[3],
            "spill_bytes": out[4], "smem_bytes_per_block": out[5],
            "blocks_per_sm": out[6]}
    return _stream_configs[key]


def _score_diag_launch(alpha, beta, fin, sc, gap_open: int, gap_extend: int,
                       rows: int, Rb: int, nb: int, plan: dict, out):
    """Launch affine_score_diag on checked CUDA inputs with ``plan``
    (``score_diag_launch_plan``): diagonal fin_b of the score-mode DP over
    rows rows (alpha rows past n read code 4) read out into out,
    (nb, B, Rb + 1) int32 with rows <= nb·Rb (see
    ``affine_block_reference``; K2's score mode is nb = 1, Rb = rows =
    n)."""
    global affine_score_diag_launches
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    W = plan["warps_per_pair"]
    # per pair, W ring rows of (max(M, I), D) a column
    ring = torch.empty((B, W * plan["ring_columns"] * 2), dtype=torch.int32,
                       device=dev)
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_score_diag_launch(
            alpha.data_ptr(), beta.data_ptr(), fin.data_ptr(), sc.data_ptr(),
            int(gap_open), int(gap_extend), B, n, m, rows, Rb, nb,
            plan["rows_per_lane"], W, ring.data_ptr(), out.data_ptr(),
            stream)
    _kernels.check(rc, "affine_score_diag")
    affine_score_diag_launches += 1
    return out


# trace_diag's modes as its library numbers them: K2's trace mode, K3's
# trace mode, K3's score mode
_TRACE_MODES = {"affine": 0, "const": 1, "const_score": 2}
# The byte of lane 0 in a padded trace row of trace_diag (lane 1 starts a
# 16-byte chunk)
TRACE_LANE0 = 15
# Rows a lane of trace_diag's trace modes. At the main shapes (128 pairs of
# 1024 x 1024) K2's trace mode ran in 0.68-0.72 ms at 4 rows a lane (8
# strips over 8 warps a pair) and in 1.56-1.58 at 8 (4 strips over 4
# warps) (NVIDIA H100 80GB HBM3, 700 W power limit; PERF.md §6,
# tools/pairwise_timing.py plans). Const's score mode takes
# STREAM_ROWS_PER_LANE, as affine_score_diag.
TRACE_ROWS_PER_LANE = 4


def _trace_diag_built(mode: str) -> dict:
    """``_diag_built`` of trace_diag in ``mode`` ("affine", "const" or
    "const_score"): its trace modes are built for the rows a lane their
    plans can take (2 and 4), const's score mode for STREAM_ROWS'."""
    return _diag_built("trace_diag", _TRACE_MODES[mode])


def trace_diag_plan(B: int, n: int, m: int, mode: str, built: dict) -> dict:
    """How trace_diag runs B pairs of n x m in ``mode`` ("affine", "const"
    or "const_score"), chosen by shape alone from what it is ``built`` for
    in that mode (``_trace_diag_built``): in the trace modes R as
    ``stream_plan`` picks it with TRACE_ROWS_PER_LANE as its main count,
    in const's score mode as ``score_diag_plan`` picks it; W warps a pair
    as ``_diag_plan`` picks them (at most built["max_warps"])."""
    main = STREAM_ROWS_PER_LANE if mode == "const_score" else \
        TRACE_ROWS_PER_LANE
    return _diag_plan(B, stream_plan(n, m, built, main)["rows_per_lane"], n,
                      m, built)


def trace_diag_launch_plan(B: int, n: int, m: int, mode: str,
                           R: int | None = None, W: int | None = None
                           ) -> dict:
    """``trace_diag_plan`` for B pairs of n x m in ``mode`` ("affine",
    "const" or "const_score"), or the forced rows a lane R and warps a
    pair W, with the launch the card's library makes of it: a block's
    threads, the blocks, the entries of a ring row, a thread's registers
    and spilled bytes, a block's shared memory, the blocks an SM holds and
    the pitch of a trace row."""
    key = ("trace", B, n, m, mode, R, W)
    if key not in _stream_configs:
        built = _trace_diag_built(mode)
        plan = trace_diag_plan(B, n, m, mode, built)
        if R is not None or W is not None:
            R = plan["rows_per_lane"] if R is None else R
            plan = {**_strips(R, n, m),
                    **_diag_block(B, plan["warps_per_pair"] if W is None
                                  else W, built)}
        out = (ctypes.c_int * 8)()
        lib = _kernels.lib("wavefront")
        _kernels.check(lib.trace_diag_shape(
            B, n, m, plan["rows_per_lane"], plan["warps_per_pair"],
            _TRACE_MODES[mode], ctypes.addressof(out)), "trace_diag")
        _stream_configs[key] = {
            **plan, "threads": out[0], "launch_blocks": out[1],
            "ring_columns": out[2], "registers": out[3],
            "spill_bytes": out[4], "smem_bytes_per_block": out[5],
            "blocks_per_sm": out[6], "trace_pitch": out[7]}
    return _stream_configs[key]


def _trace_diag_launch(mode: str, alpha, beta, fin, sc, gap_open: int,
                       gap_extend: int, plan: dict, res):
    """Launch trace_diag in ``mode`` ("affine", "const" or "const_score";
    const's gap is gap_open) on checked CUDA inputs with ``plan``
    (``trace_diag_launch_plan``) into res, the (B, n + 1) int32 results
    (rm, ri, rd for affine; res for const). Returns the trace, the
    (n + m, B, n + 1) int8 view of its padded rows, or None in
    const_score."""
    global trace_diag_launches
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    W = plan["warps_per_pair"]
    # per pair, W ring rows of (max(M, I), 2 D + (M >= I)) or C a column
    ring = torch.empty((B, W * plan["ring_columns"]
                        * (2 if mode == "affine" else 1)),
                       dtype=torch.int32, device=dev)
    rows = trace = None
    if mode != "const_score":
        rows = torch.empty((n + m, B, plan["trace_pitch"]), dtype=torch.int8,
                           device=dev)
        trace = rows[:, :, TRACE_LANE0:TRACE_LANE0 + n + 1]
    res = (*res, None, None)[:3]
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.trace_diag_launch(
            alpha.data_ptr(), beta.data_ptr(), fin.data_ptr(), sc.data_ptr(),
            int(gap_open), int(gap_extend), B, n, m, plan["rows_per_lane"], W,
            _TRACE_MODES[mode], ring.data_ptr(), *(_ptr(r) for r in res),
            _ptr(rows), stream)
    _kernels.check(rc, "trace_diag")
    trace_diag_launches += 1
    return trace


def affine_block_reference(alpha, beta, fin, scores, gap_open: int,
                           gap_extend: int, r_rows: int):
    """Plain PyTorch result of the row-blocked score-mode Gotoh DP (the
    function of ``_affine_block_kernel``, wavefront.py:466, as
    ``wavefront_align_blocked`` chains it, :569-644), (nb, B, r_rows + 1)
    int32 with nb = ceil(n / r_rows).

    Lane s of block k is row k·r_rows + s; it holds max3(M, I, D) of cell
    (k·r_rows + s, fin_b - k·r_rows - s), where alpha is padded with code
    4 up to nb·r_rows rows, and NEG where that cell lies outside the
    padded grid or where the block's local diagonal fin_b - k·r_rows is
    outside 1..r_rows + m (never reached). The blocks chain their boundary
    rows exactly, so this is one global DP over the padded grid
    (``affine_wavefront_reference``) read out per block: every block
    captures the same global diagonal fin_b."""
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    R = int(r_rows)
    nb = -(-n // R)
    padded = torch.full((B, nb * R), 4, dtype=torch.int8, device=dev)
    padded[:, :n] = alpha
    fin = as_vec(fin, B, dev)
    res = affine_wavefront_reference(padded, beta, fin, scores, gap_open,
                                     gap_extend, False)
    k = torch.arange(nb, device=dev)
    lanes = k[:, None] * R + torch.arange(R + 1, device=dev)
    out = res[:, lanes].permute(1, 0, 2)
    local = fin[None, :] - k[:, None] * R
    reached = (local >= 1) & (local <= R + m)
    return torch.where(reached[:, :, None], out, NEG).to(torch.int32)


def wavefront_align_blocked(alpha_pad, beta_pad, fin_d, scores, *, n: int,
                            m: int, gap_open: int, gap_extend: int,
                            r_rows: int = 512, prof16: bool = False,
                            device=None):
    """Score-mode affine wavefront in row blocks of r_rows lanes (the
    contract of ``wavefront_align_blocked``, wavefront.py:569): alpha_pad
    (B, n), beta_pad (B, m) int8, fin_d (B,) or (B, 1) int32 = n_b + m_b.
    Returns (nb, B, r_rows + 1) int32, nb = ceil(n / r_rows): pair b's
    score lives at block (n_b - 1) // r_rows, lane n_b - k·r_rows (see
    ``affine_block_reference`` for every lane). The JAX result has
    round_up(r_rows + 1, 128) lanes; those above r_rows are always NEG
    and are left out here. ``prof16`` (int16 profiles, a VMEM saving) is
    accepted and changes nothing.

    Tensors are used where they lie; numpy inputs go to ``device`` (None
    is the card). CPU tensors take the plain version; CUDA tensors launch
    the CUDA kernel ``affine_score_diag`` once for all row blocks (the DP
    over the nb·r_rows padded rows, ``score_diag_plan``)."""
    global affine_block_launches
    del prof16
    alpha = _tensor(alpha_pad, torch.int8, device)
    dev = alpha.device
    B = alpha.shape[0]
    alpha = expect(alpha, torch.int8, (B, n), "alpha_pad", dev)
    beta = expect(_tensor(beta_pad, torch.int8, dev), torch.int8, (B, m),
                  "beta_pad", dev)
    fin = as_vec(fin_d, B, dev).contiguous()
    sc = expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                torch.int32, (5, 5), "scores", dev)
    R = int(r_rows)
    if R < 1:
        raise ValueError(f"r_rows must be positive, got {R}")
    if dev.type == "cpu":
        return affine_block_reference(alpha, beta, fin, sc, gap_open,
                                      gap_extend, R)
    nb = -(-n // R)
    res = torch.empty((nb, B, R + 1), dtype=torch.int32, device=dev)
    if nb * B == 0:
        return res
    _score_diag_launch(alpha, beta, fin, sc, gap_open, gap_extend, nb * R, R,
                       nb, score_diag_launch_plan(B, nb * R, m), res)
    affine_block_launches += 1
    return res


# ---------------------------------------------------------------------------
# The lowmem aligner: global Gotoh alignment of pairs too long for a full
# trace. The forward keeps a two-diagonal state, (3, 2, B, S) int32: state
# k (M, I, D) of diagonals d0 - 1 (index 0) and d0 (index 1) on every lane
# s = 0..n (the TPU kernel's 8 sublane chunks, S8 = round_up(n+1, 1024)
# lanes and parity slots were its VMEM layout). The backward re-fills one
# block of K diagonals at a time inside a window of W lanes per pair and
# walks that block's trace.


def window_width(n: int, K: int) -> int:
    """W = min(S, round_up(2K + 640, 128)) lanes of a backward window
    (the JAX's W with S = n + 1 for its S8)."""
    return min(n + 1, (2 * K + 640 + 127) // 128 * 128)


def initial_state(B: int, n: int, gap_open: int, device) -> torch.Tensor:
    """The state at d0 = 0: cell (0, 0) has M = 0 and I = D = gap open;
    every other lane, and all of diagonal -1, holds NEG."""
    state = torch.full((3, 2, B, n + 1), NEG, dtype=torch.int32,
                       device=device)
    state[0, 1, :, 0] = 0
    state[1:, 1, :, 0] = int(gap_open)
    return state


def affine_fwd_block_reference(alpha, beta, state, d0: int, fin: int, scores,
                               gap_open: int, gap_extend: int, K: int):
    """Plain PyTorch forward of K diagonals d0+1..d0+K of the score-mode
    Gotoh DP over (B, S) tensors: the arithmetic of
    ``_affine_fwd_chunked_kernel`` (wavefront.py:895-975), with the
    recurrences and boundaries of ``affine_wavefront_reference``.

    alpha (B, n), beta (B, m) int8; state (3, 2, B, S) int32 at diagonals
    d0 - 1 and d0. Returns (state at d0+K-1 and d0+K, capture): capture
    (3, B, S) holds M, I and D of diagonal ``fin`` on every lane, or NEG
    where fin is not in the block (the capture is reset each block)."""
    B, n = alpha.shape
    S = n + 1
    dev = alpha.device
    go, ge = int(gap_open), int(gap_extend)
    goe = go + ge
    dg = _Diagonals(alpha, beta, scores)
    (m2, i2, d2), (m1, i1, d1) = state[:, 0], state[:, 1]
    cap = [_neg(B, S, dev)] * 3
    for d in range(d0 + 1, d0 + K + 1):
        m_new = dg.sub(d) + _shift(_max3(m2, i2, d2))
        i_new = _max3(goe + m1, ge + i1, goe + d1)
        d_new = _shift(_max3(goe + m1, goe + i1, ge + d1))
        interior = dg.interior(d)
        bnd = go + ge * d
        m_new = torch.where(interior, m_new, NEG)
        i_new = torch.where(interior, i_new,
                            _edge((dg.s == 0) & (d <= dg.m), bnd))
        d_new = torch.where(interior, d_new, _edge((dg.s == d) & (d <= n), bnd))
        if d == fin:
            cap = [m_new, i_new, d_new]
        m2, i2, d2 = m1, i1, d1
        m1, i1, d1 = m_new, i_new, d_new
    out = torch.stack([torch.stack([m2, m1]), torch.stack([i2, i1]),
                       torch.stack([d2, d1])])
    return out, torch.stack(cap)


def _window_start(i, K: int, S: int, W: int):
    """wlo = clip(floor((i - 2K - 128) / 128) * 128, 0, S - W) per pair
    (``_lowmem_backward``, wavefront.py:1153, with S for S8)."""
    x = i.to(torch.int64) - 2 * K - 128
    return (torch.div(x, 128, rounding_mode="floor") * 128).clamp(0, S - W)


def affine_bwd_window_reference(alpha, beta, state, d0: int, i, scores,
                                gap_open: int, gap_extend: int, K: int):
    """Plain PyTorch re-fill of diagonals d0+1..d0+K inside each pair's
    window of W = ``window_width(n, K)`` lanes [wlo_b, wlo_b + W): the
    arithmetic of ``_affine_bwd_window_kernel`` (wavefront.py:1007-1071).

    state (3, 2, B, S) int32 is the checkpoint at d0 - 1 and d0; i (B,)
    int32 the walk's current row, which sets wlo_b (``_window_start``).
    As in the Pallas kernel, the window's lane 0 takes its own value as
    its s - 1 neighbour (``_shift``), so cells within t lanes of the
    window's left edge on step t differ from the full DP; the walk never
    reads them (it stays at lanes >= i - K >= wlo + K + 128). Returns
    (trace, wlo): trace (K, B, W) int8 packs tM + 4 tI + 16 tD for the
    interior cells of diagonal d0 + 1 + t at lane wlo_b + w, and is 0
    elsewhere; wlo (B,) int32."""
    B, n = alpha.shape
    S = n + 1
    W = window_width(n, K)
    go, ge = int(gap_open), int(gap_extend)
    goe = go + ge
    dg = _Diagonals(alpha, beta, scores)
    wlo = _window_start(torch.as_tensor(i, device=alpha.device).reshape(B),
                        K, S, W)
    s = wlo[:, None] + torch.arange(W, device=alpha.device)
    win = state.gather(3, s.expand(3, 2, B, W))
    (m2, i2, d2), (m1, i1, d1) = win[:, 0], win[:, 1]
    trace = torch.empty((K, B, W), dtype=torch.int8, device=alpha.device)
    for t in range(K):
        d = d0 + 1 + t
        m_new = dg.sub(d, s) + _shift(_max3(m2, i2, d2))
        a_i, b_i, c_i = goe + m1, ge + i1, goe + d1
        i_new = _max3(a_i, b_i, c_i)
        b_d, c_d = goe + i1, ge + d1
        d_new = _shift(_max3(a_i, b_d, c_d))
        interior = dg.interior(d, s)
        code = (_shift(_argmax3(m2, i2, d2)) + 4 * _argmax3(a_i, b_i, c_i)
                + 16 * _shift(_argmax3(a_i, b_d, c_d)))
        trace[t] = torch.where(interior, code, 0).to(torch.int8)
        bnd = go + ge * d
        m_new = torch.where(interior, m_new, NEG)
        i_new = torch.where(interior, i_new, _edge((s == 0) & (d <= dg.m), bnd))
        d_new = torch.where(interior, d_new, _edge((s == d) & (d <= n), bnd))
        m2, i2, d2 = m1, i1, d1
        m1, i1, d1 = m_new, i_new, d_new
    return trace, wlo.to(torch.int32)


def lowmem_walk_block_reference(trace, wlo, d0: int, i, j, k):
    """Plain PyTorch traceback over one block's windowed trace: the
    arithmetic of ``_walk_block`` (wavefront.py:1102-1126).

    trace (K, B, W) int8 from ``affine_bwd_window``, wlo (B,) its window
    starts; i, j, k (B,) int32, the walk's cell and state (0 M, 1 I,
    2 D), are updated in place. Each of K steps emits the current state
    as the op while the cell is active (i >= 1, j >= 1 and its diagonal
    i + j in d0+1..d0+K), else 4, and then moves: M to (i-1, j-1), I to
    (i, j-1), D to (i-1, j), the next state read from the cell's code.
    Returns ops (K, B) int8."""
    K, B, W = trace.shape
    bidx = torch.arange(B, device=trace.device)
    ci, cj, ck = i.clone(), j.clone(), k.clone()
    ops = torch.empty((K, B), dtype=torch.int8, device=trace.device)
    for t in range(K):
        d_rel = ci + cj - 1 - d0
        active = (ci >= 1) & (cj >= 1) & (d_rel >= 0)
        dd = d_rel.clamp(0, K - 1).long()
        ss = (ci - wlo).clamp(0, W - 1).long()
        packed = trace[dd, bidx, ss].to(torch.int32)
        ops[t] = torch.where(active, ck, 4).to(torch.int8)
        k_next = torch.where(ck == 0, packed & 3,
                             torch.where(ck == 1, (packed >> 2) & 3,
                                         (packed >> 4) & 3))
        ci = ci - (active & ((ck == 0) | (ck == 2))).to(torch.int32)
        cj = cj - (active & ((ck == 0) | (ck == 1))).to(torch.int32)
        ck = torch.where(active, k_next, ck).to(torch.int32)
    i.copy_(ci)
    j.copy_(cj)
    k.copy_(ck)
    return ops


def _lowmem_inputs(alpha, beta, state, scores):
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    return (expect(alpha, torch.int8, (B, n), "alpha", dev),
            expect(beta, torch.int8, (B, m), "beta", dev),
            expect(state, torch.int32, (3, 2, B, n + 1), "state", dev),
            expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                   torch.int32, (5, 5), "scores", dev))


def fwd_block_lanes(n: int, CL: int) -> int:
    """Interior lanes a block of a cluster of CL takes in affine_fwd_block
    (the last block fewer, trailing ones possibly none)."""
    return max(1, -(-n // CL))


def cluster_size(B: int, units: int, min_units: int, resident,
                 max_units: int | None = None) -> int:
    """The cluster size of a lowmem kernel for B pairs of ``units`` lanes
    (or strips) each: the largest CL > 1 of CLUSTER_SIZES whose blocks
    keep at least ``min_units`` and at most ``max_units`` each and whose B
    clusters the card holds at once (``resident(CL)`` of them), so that
    no pair waits for another; else the smallest CL whose blocks keep at
    most ``max_units`` (1 without a maximum). More blocks a pair means
    less work a block a diagonal, but clusters that run in waves cost a
    whole sweep each."""
    fits = [CL for CL in CLUSTER_SIZES
            if max_units is None or -(-units // CL) <= max_units]
    if not fits:
        raise ValueError(f"{units} lanes or strips do not fit a cluster of "
                         f"{CLUSTER_SIZES[0]} blocks of {max_units}")
    for CL in fits:
        if CL > 1 and -(-units // CL) >= min_units and B <= resident(CL):
            return CL
    return fits[-1]


def fwd_cluster_size(B: int, n: int, resident) -> int:
    """The cluster size CL of affine_fwd_block for B pairs of n + 1 lanes
    (``cluster_size`` with blocks of at least FWD_MIN_LANES lanes)."""
    return cluster_size(B, n, FWD_MIN_LANES, resident)


_fwd_configs: dict = {}


def _fwd_config(CL: int, n: int, device) -> tuple:
    """The card's launch of affine_fwd_block with clusters of CL blocks
    for n + 1 lanes, cached: the clusters it holds at once
    (cudaOccupancyMaxActiveClusters), and the dynamic shared memory and
    threads of a block."""
    chunk = fwd_block_lanes(n, CL)
    in_smem = state_in_shared_memory(chunk, "affine")
    key = (device.index, CL, chunk, in_smem)
    if key not in _fwd_configs:
        out = (ctypes.c_int * 3)()
        lib = _kernels.lib("wavefront")
        with torch.cuda.device(device):
            rc = lib.affine_fwd_block_clusters(CL, chunk, int(in_smem),
                                               ctypes.addressof(out))
        _kernels.check(rc, "affine_fwd_block")
        _fwd_configs[key] = tuple(out)
    return _fwd_configs[key]


def fwd_block_plan(B: int, n: int, device) -> dict:
    """How affine_fwd_block runs B pairs of n + 1 lanes on the card
    ``device``: the cluster size, a block's lanes, threads and state
    (shared memory or global scratch, and its bytes), the dynamic shared
    memory it asks for, the clusters the card holds at once and the
    waves B clusters take."""
    device = torch.device(device)
    CL = fwd_cluster_size(B, n, lambda c: _fwd_config(c, n, device)[0])
    chunk = fwd_block_lanes(n, CL)
    resident, smem, threads = _fwd_config(CL, n, device)
    return {"cluster": CL, "lanes_per_block": chunk, "threads": threads,
            "state_in_shared_memory": state_in_shared_memory(chunk, "affine"),
            "state_bytes_per_block": 9 * (chunk + 1) * 4,
            "smem_bytes_per_block": smem,
            "resident_clusters": resident,
            "waves": -(-B // resident) if resident else None}


def affine_fwd_block(alpha, beta, state, d0: int, fin: int, scores,
                     gap_open: int, gap_extend: int, K: int):
    """K forward diagonals from a checkpoint (see
    ``affine_fwd_block_reference``): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors, one cluster of
    ``fwd_block_plan(B, n)["cluster"]`` blocks a pair."""
    if alpha.device.type == "cpu":
        return affine_fwd_block_reference(alpha, beta, state, d0, fin, scores,
                                          gap_open, gap_extend, K)
    alpha, beta, state, sc = _lowmem_inputs(alpha, beta, state, scores)
    B, n = alpha.shape
    CL = fwd_block_plan(B, n, alpha.device)["cluster"] if B else 1
    return _fwd_block_launch(alpha, beta, state, d0, fin, sc, gap_open,
                             gap_extend, K, CL)


def _fwd_block_launch(alpha, beta, state, d0: int, fin: int, sc,
                      gap_open: int, gap_extend: int, K: int, CL: int):
    """Launch affine_fwd_block on checked CUDA inputs with clusters of CL
    blocks (``affine_fwd_block`` picks CL; the card tests force one)."""
    global affine_fwd_block_launches
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    out = torch.empty((3, 2, B, S), dtype=torch.int32, device=dev)
    cap = torch.empty((3, B, S), dtype=torch.int32, device=dev)
    if B == 0:
        return out, cap
    chunk = fwd_block_lanes(n, CL)
    scratch = (None if state_in_shared_memory(chunk, "affine") else
               torch.empty((B * CL, 9 * (chunk + 1)), dtype=torch.int32,
                           device=dev))
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_fwd_block_launch(
            alpha.data_ptr(), beta.data_ptr(), sc.data_ptr(), int(gap_open),
            int(gap_extend), B, n, m, int(d0), int(K), int(fin), int(CL),
            chunk, state.data_ptr(), _ptr(scratch), out.data_ptr(),
            cap.data_ptr(), stream)
    _kernels.check(rc, "affine_fwd_block")
    affine_fwd_block_launches += 1
    return out, cap


def bwd_lanes_per_thread(W: int, built: dict) -> int:
    """L, the window lanes a thread of affine_bwd_window owns for a window
    of W lanes, from what the kernel is ``built`` for (``_bwd_built``): the
    smallest L at which its largest cluster of blocks of the most warps
    covers W, else the largest L (the kernel then sweeps W in passes)."""
    for L in built["lanes"]:
        if built["max_cluster"] * built["max_warps"] * 32 * L >= W:
            return L
    return built["lanes"][-1]


def bwd_cluster_size(B: int, W: int, L: int, built: dict, resident) -> int:
    """The cluster size CL of affine_bwd_window for B windows of W lanes
    at L lanes a thread: ``cluster_size`` over the window's strips of 32 L
    lanes, at most ``built["max_warps"]`` a block where the largest
    cluster holds them all (else any: the kernel makes passes), then as
    few blocks as keep that many strips a block (no block without a
    strip)."""
    strips = -(-W // (32 * L))
    cap = built["max_warps"]
    CL = cluster_size(B, strips, 1, resident,
                      cap if strips <= built["max_cluster"] * cap else None)
    return -(-strips // -(-strips // CL))


_bwd_configs: dict = {}


def _bwd_built(device) -> dict:
    """What affine_bwd_window is built for, as the kernel's library
    reports it: the most warps (strips) a block has, the largest cluster
    it takes and the lanes a thread it is built for."""
    key = ("built", device.index)
    if key not in _bwd_configs:
        out = (ctypes.c_int * 16)()
        lib = _kernels.lib("wavefront")
        _kernels.check(lib.affine_bwd_window_built(ctypes.addressof(out)),
                       "affine_bwd_window")
        _bwd_configs[key] = {"max_warps": out[0], "max_cluster": out[1],
                             "lanes": tuple(out[3:3 + out[2]])}
    return _bwd_configs[key]


def _bwd_config(W: int, CL: int, L: int, device) -> tuple:
    """The card's launch of affine_bwd_window with clusters of CL blocks
    for a window of W lanes at L lanes a thread, cached: the clusters it
    holds at once, a block's warps, the passes over the window, a block's
    threads and shared memory, and the diagonals between two progress
    reports of a strip."""
    key = (device.index, W, CL, L)
    if key not in _bwd_configs:
        out = (ctypes.c_int * 6)()
        lib = _kernels.lib("wavefront")
        with torch.cuda.device(device):
            rc = lib.affine_bwd_window_clusters(W, CL, L,
                                                ctypes.addressof(out))
        _kernels.check(rc, "affine_bwd_window")
        _bwd_configs[key] = tuple(out)
    return _bwd_configs[key]


def bwd_window_plan(B: int, n: int, K: int, device) -> dict:
    """How affine_bwd_window runs B pairs of n + 1 lanes at K diagonals a
    block on the card ``device``: the window's lanes, the lanes a thread
    owns, the cluster size, a block's warps (strips), lanes, threads and
    shared memory, the passes over the window, the diagonals between two
    progress reports of a strip, the clusters the card holds at once and
    the waves B clusters take."""
    device = torch.device(device)
    W = window_width(n, K)
    built = _bwd_built(device)
    L = bwd_lanes_per_thread(W, built)
    CL = bwd_cluster_size(B, W, L, built,
                          lambda c: _bwd_config(W, c, L, device)[0])
    resident, warps, passes, threads, smem, period = _bwd_config(W, CL, L,
                                                                 device)
    return {"cluster": CL, "lanes_per_thread": L, "warps_per_block": warps,
            "lanes_per_block": 32 * L * warps, "window_lanes": W,
            "passes": passes, "threads": threads,
            "smem_bytes_per_block": smem, "publish_period": period,
            "resident_clusters": resident,
            "waves": -(-B // resident) if resident else None}


def affine_bwd_window(alpha, beta, state, d0: int, i, scores, gap_open: int,
                      gap_extend: int, K: int):
    """Windowed re-fill of one block (see ``affine_bwd_window_reference``):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors,
    which computes each pair's window start from i on the card, one
    thread-block cluster a pair as ``bwd_window_plan`` gives it."""
    if alpha.device.type == "cpu":
        return affine_bwd_window_reference(alpha, beta, state, d0, i, scores,
                                           gap_open, gap_extend, K)
    alpha, beta, state, sc = _lowmem_inputs(alpha, beta, state, scores)
    B, n = alpha.shape
    dev = alpha.device
    i = expect(as_vec(i, B, dev), torch.int32, (B,), "i", dev)
    # no pair: nothing is launched, the plan does not matter
    plan = bwd_window_plan(B, n, K, dev) if B else {
        "cluster": 1, "lanes_per_thread": 0}
    return _bwd_window_launch(alpha, beta, state, d0, i, sc, gap_open,
                              gap_extend, K, plan["cluster"],
                              plan["lanes_per_thread"])


def _bwd_window_launch(alpha, beta, state, d0: int, i, sc, gap_open: int,
                       gap_extend: int, K: int, CL: int, L: int):
    """Launch affine_bwd_window on checked CUDA inputs with clusters of CL
    blocks at L lanes a thread (``affine_bwd_window`` picks CL and L, the
    card tests and tools/lowmem_timing.py force them)."""
    global affine_bwd_window_launches
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    W = window_width(n, K)
    trace = torch.empty((K, B, W), dtype=torch.int8, device=dev)
    wlo = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return trace, wlo
    passes = _bwd_config(W, CL, L, dev)[2]
    # the edge between passes: tagged words, zero so that no tag is stale
    edge = (torch.zeros((passes - 1, B, K, 3), dtype=torch.int64, device=dev)
            if passes > 1 else None)
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_bwd_window_launch(
            alpha.data_ptr(), beta.data_ptr(), sc.data_ptr(), int(gap_open),
            int(gap_extend), B, n, m, int(d0), int(K), W, int(CL), int(L),
            i.data_ptr(), state.data_ptr(), _ptr(edge), wlo.data_ptr(),
            trace.data_ptr(), stream)
    _kernels.check(rc, "affine_bwd_window")
    affine_bwd_window_launches += 1
    return trace, wlo


def lowmem_walk_block(trace, wlo, d0: int, i, j, k):
    """One block's traceback (see ``lowmem_walk_block_reference``): the
    plain version for CPU tensors, the CUDA kernel (one warp a pair,
    walking a tile of the trace at a time) for CUDA tensors. i, j, k are
    updated in place."""
    global lowmem_walk_launches
    if trace.device.type == "cpu":
        return lowmem_walk_block_reference(trace, wlo, d0, i, j, k)
    K, B, W = trace.shape
    dev = trace.device
    trace = expect(trace, torch.int8, (K, B, W), "trace", dev)
    wlo = expect(wlo, torch.int32, (B,), "wlo", dev)
    for name, t in (("i", i), ("j", j), ("k", k)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous int32 ({B},) on "
                             f"{dev}, updated in place")
    ops = torch.empty((K, B), dtype=torch.int8, device=dev)
    if B == 0:
        return ops
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lowmem_walk_block_launch(
            trace.data_ptr(), wlo.data_ptr(), int(d0), K, W, B, i.data_ptr(),
            j.data_ptr(), k.data_ptr(), ops.data_ptr(), stream)
    _kernels.check(rc, "lowmem_walk_block")
    lowmem_walk_launches += 1
    return ops


def lowmem_forward(alpha, beta, scores, gap_open: int, gap_extend: int,
                   K: int):
    """The forward of the lowmem aligner (``_lowmem_fwd_loop``,
    wavefront.py:1180): fb + 1 = (n+m-1)//K + 1 blocks of K diagonals,
    where the tensors lie. Returns (checkpoints, capture): checkpoints
    (fb+1, 3, 2, B, S) int32, row blk the state at the entry of block blk
    (diagonals blk*K - 1 and blk*K), and the last block's capture
    (3, B, S) of diagonal n + m."""
    B, n = alpha.shape
    m = beta.shape[1]
    K = int(K)
    fb = (n + m - 1) // K
    ck = torch.empty((fb + 1, 3, 2, B, n + 1), dtype=torch.int32,
                     device=alpha.device)
    ck[0] = initial_state(B, n, gap_open, alpha.device)
    for blk in range(fb + 1):
        state, cap = affine_fwd_block(alpha, beta, ck[blk], blk * K, n + m,
                                      scores, gap_open, gap_extend, K)
        if blk < fb:
            ck[blk + 1] = state
    return ck, cap


def lowmem_backward(i, j, k, d0s, checkpoints, alpha, beta, scores,
                    gap_open: int, gap_extend: int, K: int):
    """The backward of the lowmem aligner (``_lowmem_backward``,
    wavefront.py:1131): for each block in the order given, re-fill its
    window from its checkpoint and walk it. d0s are the blocks' starts and
    checkpoints their entry states (3, 2, B, S), both in the order walked
    (the last block first), from any forward. i, j, k (B,) int32 are the
    walk's start, updated in place to where it ends. Returns the ops
    (len(d0s), K, B) int8 (0 M, 1 I, 2 D, 4 inactive) where the tensors
    lie."""
    ops = []
    for d0, state in zip(d0s, checkpoints):
        trace, wlo = affine_bwd_window(alpha, beta, state, d0, i, scores,
                                       gap_open, gap_extend, K)
        ops.append(lowmem_walk_block(trace, wlo, d0, i, j, k))
        del trace  # one block's trace at a time (44 MB at full width)
    return torch.stack(ops)


def affine_gap_lowmem_batch(alphas, betas, scores, gap_open: int,
                            gap_extend: int, *, checkersize: int = 2048,
                            device=None):
    """Chromosome-scale affine alignment of B equal-size pairs in
    O(B (n+m)^2 / K) device memory (the contract of
    ``affine_gap_lowmem_batch``, wavefront.py:1212): a forward that keeps
    the state every K = checkersize diagonals, then per block, from the
    last, a windowed re-fill and a walk, all on ``device`` (None means
    the card) without a round trip to the host.

    alphas (B, n), betas (B, m) int8 codes. Returns a list of (score, ops,
    i0, j0) per pair: ops the backward M/I/D op codes (0/1/2, numpy int8)
    from (n, m) toward the origin, (i0, j0) where the walk stopped on row
    0 or column 0 (the residual gap run)."""
    dev = resolve_device(device)
    alpha = torch.from_numpy(np.ascontiguousarray(alphas, np.int8)).to(dev)
    beta = torch.from_numpy(np.ascontiguousarray(betas, np.int8)).to(dev)
    B, n = alpha.shape
    m = beta.shape[1]
    K = int(checkersize)
    ck, cap = lowmem_forward(alpha, beta, scores, gap_open, gap_extend, K)
    fm, fi, fd = cap[:, :, n]
    k0 = _argmax3(fm, fi, fd).to(torch.int32)
    score = torch.where(k0 == 0, fm, torch.where(k0 == 1, fi, fd))
    nb = ck.shape[0]
    i = torch.full((B,), n, dtype=torch.int32, device=dev)
    j = torch.full((B,), m, dtype=torch.int32, device=dev)
    ops = lowmem_backward(
        i, j, k0, [blk * K for blk in reversed(range(nb))],
        [ck[blk] for blk in reversed(range(nb))], alpha, beta, scores,
        gap_open, gap_extend, K)
    ops = ops.cpu().numpy().reshape(-1, B)
    score, i, j = (t.cpu().numpy() for t in (score, i, j))
    out = []
    for b in range(B):
        ob = ops[:, b]
        out.append((int(score[b]), ob[ob != 4], int(i[b]), int(j[b])))
    return out


def affine_gap_lowmem(alpha, beta, scores, gap_open: int, gap_extend: int,
                      *, checkersize: int = 2048, device=None):
    """Single-pair ``affine_gap_lowmem_batch``; returns (score, ops, i0,
    j0)."""
    [res] = affine_gap_lowmem_batch(
        np.asarray(alpha, np.int8)[None], np.asarray(beta, np.int8)[None],
        scores, gap_open, gap_extend, checkersize=checkersize, device=device)
    return res
