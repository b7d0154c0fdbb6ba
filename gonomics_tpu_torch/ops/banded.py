"""Banded local Smith-Waterman on vote-anchored windows, and its packed
traceback: the counterpart of ``gonomics_tpu/ops/wavefront.py:700-884``
(``unpack_ops``, ``_banded_kernel``, ``_banded_walk`` and
``banded_align_full``).

Two kernels, each with its plain PyTorch version beside it:

- ``banded_dp`` (CUDA ``csrc/banded.cu``) replaces the Pallas kernel
  ``_banded_kernel`` (wavefront.py:709, ``pallas_call`` at :850);
- ``banded_walk_pack`` (same file) replaces the ``lax.scan`` walk
  ``_banded_walk`` (:789) and the 2-bit packing after it (:874-883).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel, counts the launch in ``dp_launches`` or
``walk_launches``, and raises if the launch fails. It never falls back.

Band layout: lane ``c`` of row ``i`` (1-based read position) holds
window column ``j = i + c``, for BW = 64 lanes. Trace codes: 0 diagonal,
1 left (a gap in the read, cigar D), 2 up (a gap in the window, cigar
I), 3 local stop.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NEG
from . import _kernels
from ._kernels import as_vec, expect

BW = 64
HALF = NEG // 2  # base score of cells outside the valid region

dp_launches = 0
walk_launches = 0


def walk_length(L: int) -> int:
    """Steps of the backward walk for reads of length L (wavefront.py:874)."""
    return L + BW + 4


def banded_dp_reference(reads, windows, n_vec, m_vec, scores, gap: int):
    """Plain PyTorch banded DP, row by row over (B, 64) tensors; the same
    arithmetic as ``_banded_kernel`` (wavefront.py:725-785).

    reads (B, L) int8 and windows (B, W) int8 base codes, clipped to 0..4
    (window columns at or past W read code 4); n_vec, m_vec (B,) read and
    window lengths; scores (5, 5); gap < 0. Returns bv, bi (B, 64) int32,
    the best score of each lane and its first row, and the trace
    (L, B, 64) int8."""
    B, L = reads.shape
    W = windows.shape[1]
    dev = reads.device
    i32 = torch.int32
    c = torch.arange(BW, dtype=i32, device=dev)
    gap_c = gap * c
    rc = reads.to(torch.int64).clamp(0, 4)
    wc = torch.full((B, L + BW), 4, dtype=torch.int64, device=dev)
    k = min(W, L + BW)
    wc[:, :k] = windows[:, :k].to(torch.int64).clamp(0, 4)
    sc = torch.as_tensor(scores, dtype=i32, device=dev)
    n = as_vec(n_vec, B, dev)[:, None]
    m = as_vec(m_vec, B, dev)[:, None]
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    prev = torch.zeros((B, BW), dtype=i32, device=dev)
    bv = torch.zeros((B, BW), dtype=i32, device=dev)
    bi = torch.zeros((B, BW), dtype=i32, device=dev)
    trace = torch.empty((L, B, BW), dtype=torch.int8, device=dev)
    for i in range(1, L + 1):
        sub = sc[rc[:, i - 1:i], wc[:, i - 1:i - 1 + BW]]
        diag = prev + sub
        up = torch.cat([prev[:, 1:], zero_col], dim=1) + gap
        j = i + c
        valid = (i <= n) & (j >= 1) & (j <= m)
        base = torch.where(valid, torch.maximum(diag, up), HALF)
        # left-gap chain: max-prefix of base[c] - gap*c in log steps
        a = base - gap_c
        for s in (1, 2, 4, 8, 16, 32):
            fill = torch.full((B, s), HALF, dtype=i32, device=dev)
            a = torch.maximum(a, torch.cat([fill, a[:, :-s]], dim=1))
        h = torch.where(valid, torch.clamp(a + gap_c, min=0), 0)
        left = torch.cat([zero_col, h[:, :-1]], dim=1) + gap
        t = torch.where(h == 0, 3, torch.where(
            h == diag, 0, torch.where(h == left, 1, 2)))
        trace[i - 1] = t.to(torch.int8)
        upd = h > bv
        bv = torch.where(upd, h, bv)
        bi = torch.where(upd, i, bi)
        prev = h
    return bv, bi, trace


def banded_dp(reads, windows, n_vec, m_vec, scores, gap: int):
    """Banded DP (see ``banded_dp_reference``): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    global dp_launches
    B, L = reads.shape
    W = windows.shape[1]
    if W < BW:
        raise ValueError("window must be at least the band width")
    dev = reads.device
    if dev.type == "cpu":
        return banded_dp_reference(reads, windows, n_vec, m_vec, scores, gap)
    reads = expect(reads, torch.int8, (B, L), "reads", dev)
    windows = expect(windows, torch.int8, (B, W), "windows", dev)
    n_vec = expect(as_vec(n_vec, B, dev), torch.int32, (B,), "n_vec", dev)
    m_vec = expect(as_vec(m_vec, B, dev), torch.int32, (B,), "m_vec", dev)
    sc = expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                torch.int32, (5, 5), "scores", dev)
    bv = torch.empty((B, BW), dtype=torch.int32, device=dev)
    bi = torch.empty((B, BW), dtype=torch.int32, device=dev)
    trace = torch.empty((L, B, BW), dtype=torch.int8, device=dev)
    if B == 0:
        return bv, bi, trace
    lib = _kernels.lib("banded")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.banded_dp_launch(
            reads.data_ptr(), windows.data_ptr(), n_vec.data_ptr(),
            m_vec.data_ptr(), sc.data_ptr(), int(gap), B, L, W,
            bv.data_ptr(), bi.data_ptr(), trace.data_ptr(), stream)
    _kernels.check(rc, "banded_dp")
    dp_launches += 1
    return bv, bi, trace


def _walk_step(trace, i, c, act):
    """One step of every walk (``_banded_walk``, wavefront.py:789-810):
    the cells read (the live reads with i > 0, at row clamp(i - 1, 0, L -
    1), column clamp(c, 0, 63)), the op taken (code 4 once inactive; a 3
    ends the walk) and the next i, c and liveness."""
    L, B, _ = trace.shape
    reads = act & (i > 0)
    t_raw = trace[(i - 1).clamp(0, L - 1), torch.arange(B, device=i.device),
                  c.clamp(0, BW - 1)].to(torch.int64)
    act = reads & (t_raw != 3)
    t_eff = torch.where(act, t_raw, 4)
    i = i - ((t_eff == 0) | (t_eff == 2)).to(torch.int64)
    c = c - (t_eff == 1).to(torch.int64) + (t_eff == 2).to(torch.int64)
    return reads, t_eff, i, c, act


def banded_walk_pack_reference(trace, i_end, c_end, active, D: int):
    """Plain PyTorch backward walk (``_banded_walk``, wavefront.py:789-810)
    plus packing (:878-883): D steps from (i_end, c_end) for the reads
    where ``active``; returns i0, c0 (B,) int32 and the ops packed four
    per byte, low bits first, as min(op, 3) and padded with 3:
    (B, ceil(D / 4)) uint8."""
    B = trace.shape[1]
    dev = trace.device
    i = i_end.to(torch.int64)
    c = c_end.to(torch.int64)
    act = active.to(torch.bool)
    P = -(-D // 4)
    ops = torch.full((B, 4 * P), 3, dtype=torch.int64, device=dev)
    for step in range(D):
        _, ops[:, step], i, c, act = _walk_step(trace, i, c, act)
    weights = torch.tensor([1, 4, 16, 64], dtype=torch.int64, device=dev)
    packed = (ops.clamp(max=3).reshape(B, P, 4) * weights).sum(-1)
    return i.to(torch.int32), c.to(torch.int32), packed.to(torch.uint8)


TILE_ROWS = 32  # rows of the walk's tile: one a lane of its warp


def walk_rounds(trace, i_end, c_end, active, D: int):
    """The steps that read a cell and the tiles ``banded_walk_pack``'s
    kernel walks, per read (two (B,) int64 tensors), from the plain walk's
    path: a tile of TILE_ROWS rows is entered, a round of loads that the
    walk waits for, where a walk reads a row outside the tile before (its
    first read, and then the row TILE_ROWS below the tile's top), with its
    top at that row."""
    i = i_end.to(torch.int64)
    c = c_end.to(torch.int64)
    act = active.to(torch.bool)
    steps = torch.zeros_like(i)
    rounds = torch.zeros_like(i)
    rtop = torch.full_like(i, -1)  # no tile yet (the walk reads rows >= 0)
    for _ in range(D):
        x = rtop - (i - 1)
        reads, _, i_next, c, act = _walk_step(trace, i, c, act)
        load = reads & ((x < 0) | (x >= TILE_ROWS))
        rtop = torch.where(load, i - 1, rtop)
        steps += reads
        rounds += load
        i = i_next
    return steps, rounds


def banded_walk_pack(trace, i_end, c_end, active, D: int):
    """Backward walk + packing (see ``banded_walk_pack_reference``): the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    global walk_launches
    L, B, _ = trace.shape
    dev = trace.device
    if dev.type == "cpu":
        return banded_walk_pack_reference(trace, i_end, c_end, active, D)
    trace = expect(trace, torch.int8, (L, B, BW), "trace", dev)
    if trace.data_ptr() % 16:  # the kernel loads 16-byte chunks of rows
        trace = trace.clone()
    i_end = expect(i_end.to(torch.int32), torch.int32, (B,), "i_end", dev)
    c_end = expect(c_end.to(torch.int32), torch.int32, (B,), "c_end", dev)
    active = expect(active.to(torch.uint8), torch.uint8, (B,), "active", dev)
    P = -(-D // 4)
    i0 = torch.empty(B, dtype=torch.int32, device=dev)
    c0 = torch.empty(B, dtype=torch.int32, device=dev)
    packed = torch.empty((B, P), dtype=torch.uint8, device=dev)
    if B == 0:
        return i0, c0, packed
    lib = _kernels.lib("banded")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.banded_walk_pack_launch(
            trace.data_ptr(), i_end.data_ptr(), c_end.data_ptr(),
            active.data_ptr(), B, L, D, P, i0.data_ptr(), c0.data_ptr(),
            packed.data_ptr(), stream)
    _kernels.check(rc, "banded_walk_pack")
    walk_launches += 1
    return i0, c0, packed


def best_cell(bv, bi):
    """The alignment's end from the per-lane bests of ``banded_dp``:
    score, i_star, c_star (B,) int32. c_star is the first lane holding
    the max (jnp.argmax order, wavefront.py:869-871), written out so
    that no backend's tie order can change it."""
    score = bv.amax(dim=1)
    lanes = torch.arange(BW, dtype=torch.int32, device=bv.device)
    c_star = torch.where(bv == score[:, None], lanes, BW).amin(dim=1)
    i_star = bi.gather(1, c_star[:, None].to(torch.int64))[:, 0]
    return score, i_star, c_star


def banded_align_full(reads, windows, n_vec, m_vec, scores, gap: int):
    """Banded local alignment with packed traceback, the contract of
    ``banded_align_full`` (wavefront.py:815): returns score, i_end,
    j_end, i0, j0 (B,) int32 and the packed walk ops (B, ceil(D/4))
    uint8 with D = L + 68. Runs where ``reads`` lies."""
    L = reads.shape[1]
    bv, bi, trace = banded_dp(reads, windows, n_vec, m_vec, scores, gap)
    score, i_star, c_star = best_cell(bv, bi)
    i0, c0, packed = banded_walk_pack(trace, i_star, c_star, score > 0,
                                      walk_length(L))
    return score, i_star, i_star + c_star, i0, i0 + c0, packed


def unpack_ops(packed: np.ndarray, D: int) -> np.ndarray:
    """Decode 2-bit packed walk ops (``unpack_ops``, wavefront.py:700) to
    (B, D) int8 (code 3 = stop; callers treat >= 3 as the walk end). Zero
    rows decode to (0, D), where the JAX function's reshape raises."""
    B, P = packed.shape
    crumbs = (packed[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    return crumbs.reshape(B, 4 * P)[:, :D].astype(np.int8)
