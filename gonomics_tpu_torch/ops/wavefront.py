"""Anti-diagonal wavefront DPs: batched pairwise global alignment (the
contract of ``wavefront_align``, ``gonomics_tpu/ops/wavefront.py:1534``,
for ``mode="affine"`` and ``mode="const"``, with and without trace) and
the graph aligner's two extension DPs.

Four kernels, each with its plain PyTorch version beside it:

- ``affine_wavefront`` (CUDA ``csrc/wavefront.cu``) replaces the Pallas
  kernel ``_affine_kernel`` (wavefront.py:94, ``pallas_call`` at :1584);
- ``const_wavefront`` (same file) replaces ``_const_kernel`` (:243);
- ``local_wavefront`` (CUDA ``csrc/gsw_dp.cu``) replaces
  ``_local_kernel`` (:179, ``pallas_call`` :451 in ``wavefront_local``);
- ``gsw_right_wavefront`` (same file) replaces ``_gsw_right_kernel``
  (:289, ``pallas_call`` :368 in ``wavefront_gsw_right``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel, counts the launch in its module counter
(``affine_launches``, ``const_launches``, ``local_launches``,
``gsw_right_launches``), and raises if the launch fails. It never falls
back.

Layout: cell (i, j) lies on diagonal d = i + j at lane s = i, so results
are (B, S) int32 and the trace is (n+m, B, S) int8 with row d-1 holding
diagonal d, for S = n + 1 (the TPU's S, a multiple of 128 lanes, was its
lane quantum). Affine trace codes pack tM + 4 tI + 16 tD, each the
predecessor state in tie order M(0) > I(1) > D(2); const codes are that
argmax of (diag, left, up). Every interior cell (1 <= i <= n,
1 <= j <= m) holds the code the Pallas kernel writes there; row 0,
column 0 and the lanes outside the grid hold 0 (there the Pallas kernel
writes the argmax of its lane shift's junk, which no walk reads). Each
pair's result is its diagonal n_b + m_b (``fin``), with every lane of
the grid on that diagonal; read lane n_b. A pair whose diagonal is never
reached keeps NEG. The graph kernels' layout and trace are described at
``local_wavefront_reference`` and ``gsw_right_wavefront_reference``.
"""

from __future__ import annotations

import torch

from .. import NEG
from . import _kernels
from ._kernels import as_vec, expect

# Largest diagonal state (3 slots of (n+1) int32 lanes per state) kept in
# shared memory; above it the kernels keep it in a global scratch. The
# card allows a block 227 KB.
SMEM_STATE_BYTES_MAX = 200 * 1024

affine_launches = 0
const_launches = 0
local_launches = 0
gsw_right_launches = 0


def state_in_shared_memory(n: int, mode: str) -> bool:
    """Whether the kernel for ``mode`` keeps the diagonal state of an
    alpha of padded length n in shared memory."""
    states = 3 if mode == "affine" else 1
    return states * 3 * (n + 1) * 4 <= SMEM_STATE_BYTES_MAX


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

    def sub(self, d: int):
        """(B, S) substitution score of cell (s, d - s)."""
        row = self.rows[:, d + self.n - self.s]
        return self.sc[row * 5 + self.al]

    def interior(self, d: int):
        return (self.s >= max(1, d - self.m)) & (self.s <= min(d - 1, self.n))


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
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    global affine_launches
    if alpha.device.type == "cpu":
        return affine_wavefront_reference(alpha, beta, fin, scores, gap_open,
                                          gap_extend, with_trace)
    alpha, beta, fin, sc = _launch_inputs(alpha, beta, fin, scores)
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    res = [torch.empty((B, S), dtype=torch.int32, device=dev)
           for _ in range(3 if with_trace else 1)]
    trace = (torch.empty((n + m, B, S), dtype=torch.int8, device=dev)
             if with_trace else None)
    out = (*res, trace) if with_trace else res[0]
    if B == 0:
        return out
    scratch = (None if state_in_shared_memory(n, "affine") else
               torch.empty((B, 9 * S), dtype=torch.int32, device=dev))
    rm, ri, rd = res if with_trace else (res[0], None, None)
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.affine_wavefront_launch(
            alpha.data_ptr(), beta.data_ptr(), fin.data_ptr(), sc.data_ptr(),
            int(gap_open), int(gap_extend), B, n, m, int(with_trace),
            _ptr(scratch), rm.data_ptr(), _ptr(ri), _ptr(rd), _ptr(trace),
            stream)
    _kernels.check(rc, "affine_wavefront")
    affine_launches += 1
    return out


def const_wavefront(alpha, beta, fin, scores, gap: int, with_trace: bool):
    """Global linear-gap wavefront (see ``const_wavefront_reference``):
    the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    global const_launches
    if alpha.device.type == "cpu":
        return const_wavefront_reference(alpha, beta, fin, scores, gap,
                                         with_trace)
    alpha, beta, fin, sc = _launch_inputs(alpha, beta, fin, scores)
    B, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    res = torch.empty((B, S), dtype=torch.int32, device=dev)
    trace = (torch.empty((n + m, B, S), dtype=torch.int8, device=dev)
             if with_trace else None)
    out = (res, trace) if with_trace else res
    if B == 0:
        return out
    scratch = (None if state_in_shared_memory(n, "const") else
               torch.empty((B, 3 * S), dtype=torch.int32, device=dev))
    lib = _kernels.lib("wavefront")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.const_wavefront_launch(
            alpha.data_ptr(), beta.data_ptr(), fin.data_ptr(), sc.data_ptr(),
            int(gap), B, n, m, int(with_trace), _ptr(scratch), res.data_ptr(),
            _ptr(trace), stream)
    _kernels.check(rc, "const_wavefront")
    const_launches += 1
    return out


def _graph_inputs(alpha, beta, n_vec, m_vec, scores, states: int):
    """The graph kernels' checked inputs; raises where their state of
    ``states`` int32 rows of n+1 lanes would not fit in shared memory."""
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    if states * (n + 1) * 4 > SMEM_STATE_BYTES_MAX:
        raise ValueError(f"genome window of {n} bases: the graph kernels "
                         "keep their state in shared memory, which holds "
                         f"at most {SMEM_STATE_BYTES_MAX // (4 * states) - 1}")
    return (expect(alpha, torch.int8, (C, n), "alpha", dev),
            expect(beta, torch.int8, (C, m), "beta", dev),
            expect(as_vec(n_vec, C, dev), torch.int32, (C,), "n_vec", dev),
            expect(as_vec(m_vec, C, dev), torch.int32, (C,), "m_vec", dev),
            expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                   torch.int32, (5, 5), "scores", dev))


def local_wavefront(alpha, beta, n_vec, m_vec, scores, gap: int,
                    with_corner: bool = False):
    """Local linear-gap DP of the graph aligner's left extension (see
    ``local_wavefront_reference``): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    global local_launches
    if alpha.device.type == "cpu":
        return local_wavefront_reference(alpha, beta, n_vec, m_vec, scores,
                                         gap, with_corner)
    alpha, beta, n_vec, m_vec, sc = _graph_inputs(alpha, beta, n_vec, m_vec,
                                                  scores, 6)
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    bv = torch.empty((C, S), dtype=torch.int32, device=dev)
    bd = torch.empty((C, S), dtype=torch.int32, device=dev)
    corner = (torch.empty((C, S), dtype=torch.int32, device=dev)
              if with_corner else None)
    trace = torch.empty((n + m, C, S), dtype=torch.int8, device=dev)
    out = (bv, bd, trace, corner) if with_corner else (bv, bd, trace)
    if C == 0:
        return out
    lib = _kernels.lib("gsw_dp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.local_wavefront_launch(
            alpha.data_ptr(), beta.data_ptr(), n_vec.data_ptr(),
            m_vec.data_ptr(), sc.data_ptr(), int(gap), C, n, m,
            bv.data_ptr(), bd.data_ptr(), _ptr(corner), trace.data_ptr(),
            stream)
    _kernels.check(rc, "local_wavefront")
    local_launches += 1
    return out


def gsw_right_wavefront(alpha, beta, n_vec, m_vec, scores, gap: int):
    """Prefix-anchored linear-gap DP of the graph aligner's right
    extension (see ``gsw_right_wavefront_reference``): the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    global gsw_right_launches
    if alpha.device.type == "cpu":
        return gsw_right_wavefront_reference(alpha, beta, n_vec, m_vec,
                                             scores, gap)
    alpha, beta, n_vec, m_vec, sc = _graph_inputs(alpha, beta, n_vec, m_vec,
                                                  scores, 5)
    C, n = alpha.shape
    m = beta.shape[1]
    dev = alpha.device
    S = n + 1
    bv = torch.empty((C, S), dtype=torch.int32, device=dev)
    bd = torch.empty((C, S), dtype=torch.int32, device=dev)
    trace = torch.empty((n + m, C, S), dtype=torch.int8, device=dev)
    if C == 0:
        return bv, bd, trace
    lib = _kernels.lib("gsw_dp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_right_wavefront_launch(
            alpha.data_ptr(), beta.data_ptr(), n_vec.data_ptr(),
            m_vec.data_ptr(), sc.data_ptr(), int(gap), C, n, m,
            bv.data_ptr(), bd.data_ptr(), trace.data_ptr(), stream)
    _kernels.check(rc, "gsw_right_wavefront")
    gsw_right_launches += 1
    return bv, bd, trace


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
