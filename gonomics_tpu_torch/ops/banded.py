"""Banded local Smith-Waterman on vote-anchored windows, and its packed
traceback: the counterpart of ``gonomics_tpu/ops/wavefront.py:700-884``
(``unpack_ops``, ``_banded_kernel``, ``_banded_walk`` and
``banded_align_full``).

The CUDA kernels of ``csrc/banded.cu``, each with its plain PyTorch
version beside it:

- ``banded_dp`` replaces the Pallas kernel ``_banded_kernel``
  (wavefront.py:709, ``pallas_call`` at :850): the banded DP with its
  int8 trace and per-lane bests;
- ``banded_align_fused`` is the same kernel in its fused mode: the DP,
  with the trace kept in shared memory at 2 bits a code, then the best
  cell, the walk and the packing in the same block, the whole of
  ``banded_align_full`` in one launch;
- ``banded_walk_pack`` replaces the ``lax.scan`` walk ``_banded_walk``
  (:789) and the 2-bit packing after it (:874-883).

``banded_align_full`` on CUDA tensors takes the fused kernel wherever
``banded_plan`` finds that a block's traces fit its shared memory (a
choice by read length), else ``banded_dp``, ``best_cell`` and
``banded_walk_pack``. ``banded_dp`` stages its codes in shared memory
wherever one read's read and window fit there, and past that (reads above
about 116 kbp on an H100) reads them from device memory (``banded_plan``'s
``codes``). A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches its kernel, counts the launch in
``dp_launches``, ``fused_launches`` or ``walk_launches``, and raises if
the launch fails. It never falls back.

Band layout: lane ``c`` of row ``i`` (1-based read position) holds
window column ``j = i + c``, for BW = 64 lanes. Trace codes: 0 diagonal,
1 left (a gap in the read, cigar D), 2 up (a gap in the window, cigar
I), 3 local stop.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import NEG
from . import _kernels
from ._kernels import as_vec, expect

BW = 64
HALF = NEG // 2  # base score of cells outside the valid region

dp_launches = 0
fused_launches = 0
walk_launches = 0

# The plan of banded_dp's kernel (banded_plan). A mode takes its most
# lanes a thread (BANDED_LANES_PER_THREAD) where the reads give at least
# BANDED_FILL_WARPS warps at that count, else half as many; and
# BANDED_WARPS warps a block where they give that many warps (blocks of 8
# then take 128 or more of the H100's 132 SMs), else 4, one a scheduler
# of each SM a block takes, so that fewer reads spread over more SMs.
# tools/banded_timing.py plans (CUDA graph ms; NVIDIA H100 80GB HBM3, 700
# W power limit; PERF.md §6) has a workload on each side of each choice,
# those at 1024 warps fastest at the most lanes and 8 warps, those at 512
# or fewer at half the lanes and 4 warps or fewer. Fused: 4096 x 150 bp
# reads 0.0796 at 8 lanes against 0.0827 at 4; 2048 x 150 0.0554 at 4
# against 0.0623 at 8; 400 x 150 0.0463 at 4 lanes and 2 warps (0.0465 at
# 4 warps) against 0.0554 at 8 warps and 0.0474 at 2 lanes. Trace mode:
# 4096 x 150 0.0672 at 4 against 0.0834 at 2; 1024 x 13,000 2.946 at 2
# against 3.100 at 4; 64 x 13,000 2.728 at 2 lanes and 1 warp (2.736 at 4
# warps) against 2.949 at 8 warps and 3.093 at 4 lanes.
BANDED_LANES_PER_THREAD = {"fused": 8, "dp": 4}
BANDED_WARPS = 8
BANDED_FILL_WARPS = 1024

_configs: dict = {}


def walk_length(L: int) -> int:
    """Steps of the backward walk for reads of length L (wavefront.py:874)."""
    return L + BW + 4


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _staged_pitch(cols: int) -> int:
    """``staged_pitch`` of banded.cu: the bytes of a staged row of cols
    codes in shared memory."""
    return _round_up(cols, 128) + 64


def smem_bytes(R: int, WB: int, L: int, fused: bool,
               codes: str = "staged") -> int:
    """``banded_smem`` of banded.cu: the dynamic shared memory of a block
    of WB warps at R lanes a thread for reads of L, the staged read and
    window codes of its WB R / 2 reads and, fused, their traces at 16
    bytes a row; 0 where the codes stay in device memory ("global")."""
    if codes == "global":
        return 0
    return WB * R // 2 * (_staged_pitch(L) + _staged_pitch(L + BW)
                          + (16 * L if fused else 0))


def _banded_built(dev: torch.device) -> dict:
    """What banded_dp's kernel is built for, as its library reports it on
    the card ``dev``: the most warps a block, the most dynamic shared
    memory a block can take, the lanes a thread (rising), and for each the
    registers and spilled bytes a thread of the trace mode, of the fused
    mode and of the trace mode with its codes in device memory. The first
    call on a card also lets the kernel take that shared memory there."""
    key = ("built", dev.index)
    if key not in _configs:
        out = (ctypes.c_int * 32)()
        with torch.cuda.device(dev):
            _kernels.check(_kernels.lib("banded").banded_built(
                ctypes.addressof(out)), "banded_dp")
        e = [out[3 + 7 * k:10 + 7 * k] for k in range(out[2])]
        lanes = tuple(x[0] for x in e)
        _configs[key] = {
            "max_warps": out[0], "smem_limit": out[1],
            "lanes_per_thread": lanes,
            "registers": {x[0]: tuple(x[1::2]) for x in e},
            "spill_bytes": {x[0]: tuple(x[2::2]) for x in e}}
    return _configs[key]


def _variant(plan: dict) -> int:
    """The index of a plan's kernel in ``_banded_built``'s registers and
    spills: 0 the trace mode, 1 the fused mode, 2 the trace mode with its
    codes in device memory."""
    return 1 if plan["mode"] == "fused" else 2 * (plan["codes"] == "global")


def _block(R: int, WB: int) -> dict:
    return {"lanes_per_thread": R, "threads_per_read": BW // R,
            "warps_per_block": WB, "reads_per_block": WB * R // 2}


def _warps(B: int, R: int) -> int:
    """The warps B reads take at R lanes a thread (2 R reads a warp)."""
    return -(-2 * B // R)


def _lanes(B: int, mode: str, built: dict) -> int:
    """The lanes a thread banded_plan takes for B reads in ``mode``: the
    mode's BANDED_LANES_PER_THREAD where the reads give BANDED_FILL_WARPS
    warps at it, else half that; the nearest count whose kernels spill
    nothing where that one spills (in its staged trace or fused mode)."""
    most = BANDED_LANES_PER_THREAD[mode]
    want = most if _warps(B, most) >= BANDED_FILL_WARPS else most // 2
    lanes = built["lanes_per_thread"]
    clean = ([r for r in lanes if not any(built["spill_bytes"][r][:2])]
             or lanes)
    return min(clean, key=lambda r: (abs(r - want), r))


def _plan(B: int, L: int, mode: str, codes: str, R: int, WB: int) -> dict:
    block = _block(R, WB)
    return {"mode": mode, "codes": codes, **block,
            "blocks": -(-B // block["reads_per_block"]),
            "smem_bytes": smem_bytes(R, WB, L, mode == "fused", codes)}


def banded_plan(B: int, L: int, built: dict, mode: str | None = None,
                R: int | None = None, WB: int | None = None,
                codes: str | None = None) -> dict:
    """How banded_dp's kernel runs B reads of L, chosen by shape alone
    from what it is ``built`` for (``_banded_built``): the mode, "fused"
    where a block holds its reads' traces in shared memory, else "dp",
    the trace mode (``mode`` forces one); R lanes a thread (forced, or
    ``_lanes``); WB warps a block (forced, or BANDED_WARPS where the reads
    give BANDED_FILL_WARPS warps, else 4; no more than the reads need, or
    the most below that whose shared memory fits); and where the codes
    are, "staged" in shared memory, or "global", read from device memory,
    which only the trace mode takes, and only where its staged codes do
    not fit at one warp a block (reads longer than about half the card's
    shared memory a block, some 116 kbp on an H100); ``codes`` forces
    one. Raises where a forced choice does not fit."""
    lanes = built["lanes_per_thread"]
    if R is not None and R not in lanes:
        raise ValueError(f"banded_dp is not built for {R} lanes a thread")
    if WB is not None and not 1 <= WB <= built["max_warps"]:
        raise ValueError(f"banded_dp takes 1-{built['max_warps']} warps a "
                         "block")
    if codes not in (None, "staged", "global"):
        raise ValueError(f"unknown codes {codes!r}")
    if codes == "global" and mode == "fused":
        raise ValueError("the fused mode stages its codes")
    limit = built["smem_limit"]
    modes = ("dp",) if codes == "global" else ("fused", "dp")
    for m in ((mode,) if mode else modes):
        r = R or _lanes(B, m, built)
        warps = _warps(B, r)
        most = WB or max(1, min(BANDED_WARPS if warps >= BANDED_FILL_WARPS
                                else 4, built["max_warps"], warps))
        if codes == "global" or (
                m == "dp" and codes is None
                and smem_bytes(r, 1, L, False) > limit):
            return _plan(B, L, "dp", "global", r, most)
        fit = [w for w in range(most, 0 if WB is None else most - 1, -1)
               if smem_bytes(r, w, L, m == "fused") <= limit]
        if fit:
            return _plan(B, L, m, "staged", r, fit[0])
    raise ValueError(
        f"reads of {L} bp do not fit banded_dp's shared memory "
        f"({limit} bytes a block) in this plan")


def banded_launch_plan(B: int, L: int, mode: str | None = None,
                       R: int | None = None, WB: int | None = None,
                       dev: torch.device | None = None,
                       codes: str | None = None) -> dict:
    """``banded_plan`` for B reads of L on the card ``dev`` (or the forced
    mode, lanes a thread R, warps a block WB and codes) with the launch
    the card's library makes of it: a block's threads, the blocks, its
    shared memory (all, and the dynamic part), the blocks an SM holds, and
    a thread's registers and spilled bytes. For reports and tests; a
    launch takes ``banded_plan`` alone."""
    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    built = _banded_built(dev)
    plan = banded_plan(B, L, built, mode, R, WB, codes)
    R = plan["lanes_per_thread"]
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        _kernels.check(_kernels.lib("banded").banded_shape(
            B, L, R, plan["warps_per_block"], int(plan["mode"] == "fused"),
            int(plan["codes"] == "global"), ctypes.addressof(out)),
            "banded_dp")
    if out[3] != plan["smem_bytes"]:
        raise RuntimeError("banded_dp: the library's shared memory "
                           f"{out[3]} is not the plan's")
    v = _variant(plan)
    return {**plan, "threads": out[0], "launch_blocks": out[1],
            "smem_bytes_per_block": out[2], "blocks_per_sm": out[4],
            "registers": built["registers"][R][v],
            "spill_bytes": built["spill_bytes"][R][v]}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, copied where it does not start on 16 bytes (the kernel stages
    rows with 16-byte loads)."""
    return t.clone() if t.data_ptr() % 16 else t


def _dp_inputs(reads, windows, n_vec, m_vec, scores):
    """The checked CUDA inputs of banded_dp's kernel."""
    B, L = reads.shape
    W = windows.shape[1]
    dev = reads.device
    return (_aligned(expect(reads, torch.int8, (B, L), "reads", dev)),
            _aligned(expect(windows, torch.int8, (B, W), "windows", dev)),
            expect(as_vec(n_vec, B, dev), torch.int32, (B,), "n_vec", dev),
            expect(as_vec(m_vec, B, dev), torch.int32, (B,), "m_vec", dev),
            expect(torch.as_tensor(scores, dtype=torch.int32, device=dev),
                   torch.int32, (5, 5), "scores", dev))


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


def _banded_launch(plan: dict, reads, windows, n_vec, m_vec, scores,
                   gap: int):
    """One launch of banded_dp's kernel on CUDA tensors in the mode, lanes
    a thread and warps a block of ``plan`` (``banded_plan``), counted in
    ``dp_launches`` or ``fused_launches``. Returns the trace mode's bv,
    bi and trace, or the fused mode's score, i_end, j_end, i0, j0 and
    packed ops."""
    global dp_launches, fused_launches
    B, L = reads.shape
    W = windows.shape[1]
    dev = reads.device
    args = _dp_inputs(reads, windows, n_vec, m_vec, scores)
    fused = plan["mode"] == "fused"
    if fused:
        D = walk_length(L)
        P = -(-D // 4)
        outs = [torch.empty(B, dtype=torch.int32, device=dev)
                for _ in range(5)]
        outs.append(torch.empty((B, P), dtype=torch.uint8, device=dev))
    else:
        outs = [torch.empty((B, BW), dtype=torch.int32, device=dev),
                torch.empty((B, BW), dtype=torch.int32, device=dev),
                torch.empty((L, B, BW), dtype=torch.int8, device=dev)]
    if B == 0:
        return tuple(outs)
    _banded_built(dev)  # lets the kernel take its shared memory here
    lib = _kernels.lib("banded")
    shape = (plan["lanes_per_thread"], plan["warps_per_block"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fused:
            rc = lib.banded_fused_launch(
                *(a.data_ptr() for a in args), int(gap), B, L, W, D, P,
                *shape, *(o.data_ptr() for o in outs), stream)
        else:
            rc = lib.banded_dp_launch(
                *(a.data_ptr() for a in args), int(gap), B, L, W, *shape,
                int(plan["codes"] == "global"),
                *(o.data_ptr() for o in outs), stream)
    _kernels.check(rc, "banded_align_fused" if fused else "banded_dp")
    if fused:
        fused_launches += 1
    else:
        dp_launches += 1
    return tuple(outs)


def _check_window(windows) -> None:
    if windows.shape[1] < BW:
        raise ValueError("window must be at least the band width")


def banded_dp(reads, windows, n_vec, m_vec, scores, gap: int):
    """Banded DP (see ``banded_dp_reference``): the plain version for CPU
    tensors, the CUDA kernel in its trace mode for CUDA tensors, with
    ``banded_plan``'s lanes a thread, warps a block and codes."""
    _check_window(windows)
    dev = reads.device
    if dev.type == "cpu":
        return banded_dp_reference(reads, windows, n_vec, m_vec, scores, gap)
    plan = banded_plan(*reads.shape, _banded_built(dev), "dp")
    return _banded_launch(plan, reads, windows, n_vec, m_vec, scores, gap)


def banded_align_fused(reads, windows, n_vec, m_vec, scores, gap: int):
    """``banded_align_full`` in one launch: the CUDA kernel of
    ``banded_dp`` in its fused mode for CUDA tensors (raises where its
    plan does not fit), its plain version
    (``banded_align_full_reference``) for CPU tensors."""
    _check_window(windows)
    dev = reads.device
    if dev.type == "cpu":
        return banded_align_full_reference(reads, windows, n_vec, m_vec,
                                           scores, gap)
    plan = banded_plan(*reads.shape, _banded_built(dev), "fused")
    return _banded_launch(plan, reads, windows, n_vec, m_vec, scores, gap)


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


def _align_full(dp, walk, reads, windows, n_vec, m_vec, scores, gap: int):
    """banded_align_full's contract from a DP (``banded_dp`` or its plain
    version), ``best_cell`` and a walk (``banded_walk_pack`` or its plain
    version)."""
    L = reads.shape[1]
    bv, bi, trace = dp(reads, windows, n_vec, m_vec, scores, gap)
    score, i_star, c_star = best_cell(bv, bi)
    i0, c0, packed = walk(trace, i_star, c_star, score > 0, walk_length(L))
    return score, i_star, i_star + c_star, i0, i0 + c0, packed


def banded_align_full_reference(reads, windows, n_vec, m_vec, scores,
                                gap: int):
    """Plain ``banded_align_full``: ``banded_dp_reference``,
    ``best_cell`` and ``banded_walk_pack_reference``."""
    return _align_full(banded_dp_reference, banded_walk_pack_reference,
                       reads, windows, n_vec, m_vec, scores, gap)


def banded_align_full(reads, windows, n_vec, m_vec, scores, gap: int):
    """Banded local alignment with packed traceback, the contract of
    ``banded_align_full`` (wavefront.py:815): returns score, i_end,
    j_end, i0, j0 (B,) int32 and the packed walk ops (B, ceil(D/4))
    uint8 with D = L + 68. Runs where ``reads`` lies: on the card as one
    fused launch where ``banded_plan`` says it fits, else as
    ``banded_dp``, ``best_cell`` and ``banded_walk_pack``."""
    dev = reads.device
    if dev.type == "cpu":
        return banded_align_full_reference(reads, windows, n_vec, m_vec,
                                           scores, gap)
    _check_window(windows)
    plan = banded_plan(*reads.shape, _banded_built(dev))
    if plan["mode"] == "fused":
        return _banded_launch(plan, reads, windows, n_vec, m_vec, scores,
                              gap)

    def dp(*args):
        return _banded_launch(plan, *args)

    return _align_full(dp, banded_walk_pack, reads, windows, n_vec, m_vec,
                       scores, gap)


def unpack_ops(packed: np.ndarray, D: int) -> np.ndarray:
    """Decode 2-bit packed walk ops (``unpack_ops``, wavefront.py:700) to
    (B, D) int8 (code 3 = stop; callers treat >= 3 as the walk end). Zero
    rows decode to (0, D), where the JAX function's reshape raises."""
    B, P = packed.shape
    crumbs = (packed[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    return crumbs.reshape(B, 4 * P)[:, :D].astype(np.int8)
