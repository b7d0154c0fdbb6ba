"""Batched extension DPs of the graph aligner on the card: the live API of
``gonomics_tpu/ops/gsw_dp.py`` ``GswDpBatch`` (``dims_for`` :249,
``start_wave`` :258, ``finish_wave`` :309) and ``_routes_walk_order``
(:73); the rows are decoded by ``banded.unpack_ops``.

Every (genome window, read part) job of a wave goes through one launch a
side: ``local_wavefront`` (LeftDynamicAln) for the left jobs and
``gsw_right_wavefront`` (RightDynamicAln) for the right ones, each then
through the walk kernel ``gsw_walk_pack`` (CUDA ``csrc/gsw_dp.cu``; it
replaces the jnp glue ``_left_full`` / ``_right_full``, ``_walk_left`` /
``_walk_right`` and ``_pack_result``, gsw_dp.py:30-157). Its plain
PyTorch version is ``gsw_walk_pack_reference``; the wrapper takes it for
CPU tensors and launches the kernel, counted in ``walk_launches``, for
CUDA tensors. Its third side, "local", is the walk of the read aligner's
mesh path (``ops.wavefront.local_align_full``: the jnp glue of
wavefront.py:661-696), counted in ``local_walk_launches``.

A wave's result keeps the layout of ``_both_full`` (:160-184): one uint8
row per job, a 12-byte little-endian meta (score, i, j) and then the
walk ops 2 bits each, four to a byte, padded with 3; left rows first,
then right rows, zero-padded to the wider side. Unlike the JAX class, a
wave is one launch a side over all its rows (no fixed 256/1024-row
chunks, which kept XLA's shapes from recompiling), and the job codes are
uploaded as int8 rather than packed two to a byte (codes 0-12 fit
either). The sticky 64-multiple dims stay: the widths of the ops follow
them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import DeviceResult, resolve_device
from ..io.cigar import CigarOp
from . import _kernels
from ._kernels import as_vec, expect
from .banded import unpack_ops
from .wavefront import gsw_right_wavefront, local_wavefront

walk_launches = 0
local_walk_launches = 0
SIDES = {"right": 0, "left": 1, "local": 2}  # as gsw_walk_pack_launch's


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _walk_start(side: str, values, diags, n_vec, m_vec, C: int, S: int):
    """Where one side's walks start: score, i, j (int64) and whether each
    walk is live. Left (``_left_full``): score = corner at lane n_b, the
    walk from (n_b, m_b) while the score is > 0. Right (``_right_full``)
    and local (``local_align_full``): the first lane of the maximal bv, j
    = bd - i there; a max <= 0 gives (0, 0) and score 0. (The local
    side's bv is >= 0, so its max <= 0 is jnp.argmax's lane 0, whose bd is
    0.)"""
    if side not in SIDES:
        raise ValueError(f"unknown walk side {side!r}")
    dev = values.device
    if side == "left":
        i = as_vec(n_vec, C, dev).to(torch.int64)
        j = as_vec(m_vec, C, dev).to(torch.int64)
        score = values.gather(1, i.clamp(0, S - 1)[:, None])[:, 0]
        return score, i, j, score > 0
    max_v = values.amax(dim=1)
    lanes = torch.arange(S, dtype=torch.int64, device=dev)
    max_i = torch.where(values == max_v[:, None], lanes, S).amin(dim=1)
    max_j = diags.gather(1, max_i[:, None])[:, 0].to(torch.int64) - max_i
    none = max_v <= 0
    return (torch.where(none, 0, max_v), torch.where(none, 0, max_i),
            torch.where(none, 0, max_j), ~none)


def _walk_step(side: str, trace, i, j, act):
    """One step of every walk: the cells read (the jobs that read one, at
    (i, j) before the step), the op taken (code 4 once inactive) and the
    next i, j and liveness. Cell (i, j) lies on row clamp(i + j - 1, 0, D
    - 1) at lane clamp(i, 0, S - 1). Left and local: a walk reads while
    live with i and j > 0, and a code 3 ends it; right: while i or j is >
    0, with i and j clamped at 0."""
    D, C, S = trace.shape
    bidx = torch.arange(C, device=trace.device)
    stops = side != "right"
    if stops:
        reads = act & (i > 0) & (j > 0)
    else:
        reads = (i > 0) | (j > 0)
    t_raw = trace[(i + j - 1).clamp(0, D - 1), bidx,
                  i.clamp(0, S - 1)].to(torch.int64)
    if stops:
        act = reads & (t_raw != 3)
        t_eff = torch.where(act, t_raw, 4)
    else:
        t_eff = torch.where(reads, t_raw, 4)
    i = i - ((t_eff == 0) | (t_eff == 2)).to(torch.int64)
    j = j - ((t_eff == 0) | (t_eff == 1)).to(torch.int64)
    if side == "right":
        i, j = i.clamp(min=0), j.clamp(min=0)
    return reads, t_eff, i, j, act


def gsw_walk_pack_reference(side: str, trace, values, diags=None,
                            n_vec=None, m_vec=None):
    """Plain PyTorch walk and packing of one side's DP results.

    trace (D, C, S) int8 with D = n + m and S = n + 1. side "left"
    (``_left_full``, gsw_dp.py:102): values is the corner capture (C, S),
    n_vec / m_vec (C,) the jobs' lengths; score = corner at lane n_b, and
    the walk starts at (n_b, m_b) and moves while the score is > 0, i and
    j are > 0 and the code is not 3; the meta is (score, i, j) where it
    stopped. side "right" (``_right_full``, :121): values, diags are bv,
    bd (C, S); the end is the first lane of the maximal bv (a max <= 0
    gives (0, 0) and score 0), j = bd - i there, and the walk goes to the
    origin with i and j clamped at 0; the meta is (score, i, j) of the
    end. side "local" (``local_align_full``, wavefront.py:661-696):
    values, diags are K4's bv, bd; the right side's end, the left side's
    walk while the score is > 0; the meta is (score, i_end, j_end, i0,
    j0), the end and where the walk stopped. All run D steps, code 4 once
    inactive. Returns (C, 12 + P) uint8 rows, (C, 20 + P) for the local
    side, P = ceil(D / 4)."""
    D, C, S = trace.shape
    dev = trace.device
    score, i, j, act = _walk_start(side, values, diags, n_vec, m_vec, C, S)
    start = (i, j)
    P = -(-D // 4)
    ops = torch.full((C, 4 * P), 3, dtype=torch.int64, device=dev)
    for step in range(D):
        _, ops[:, step], i, j, act = _walk_step(side, trace, i, j, act)
    fields = {"left": (i, j), "right": start, "local": (*start, i, j)}[side]
    meta = torch.stack([score.to(torch.int64), *fields],
                       dim=1).to(torch.int32)
    weights = torch.tensor([1, 4, 16, 64], dtype=torch.int64, device=dev)
    packed = (ops.clamp(max=3).reshape(C, P, 4) * weights).sum(-1)
    return torch.cat([meta.contiguous().view(torch.uint8),
                      packed.to(torch.uint8)], dim=1)


GSW_TILE = (32, 16)  # the walk's tile, (diagonals, lanes), as gsw_dp.cu's


def walk_rounds(side: str, trace, values, diags=None, n_vec=None,
                m_vec=None):
    """The steps that read a cell and the tiles ``gsw_walk_pack``'s kernel
    loads, per job (two (C,) int64 tensors), from the plain walk's path
    with tiles of GSW_TILE: a tile is loaded where a walk reads a cell
    outside the one before, with its corner (u, i) = (i + j - 1, i) at
    that cell."""
    TD, TL = GSW_TILE
    D, C, S = trace.shape
    _, i, j, act = _walk_start(side, values, diags, n_vec, m_vec, C, S)
    steps = torch.zeros(C, dtype=torch.int64, device=trace.device)
    rounds = torch.zeros_like(steps)
    dtop = torch.zeros_like(steps)
    itop = torch.full_like(steps, -TL)  # no tile yet
    for _ in range(D):
        u = i + j - 1
        x, y = dtop - u, itop - i
        reads, _, i_next, j_next, act = _walk_step(side, trace, i, j, act)
        load = reads & ((x < 0) | (x >= TD) | (y < 0) | (y >= TL))
        dtop = torch.where(load, u, dtop)
        itop = torch.where(load, i, itop)
        steps += reads
        rounds += load
        i, j = i_next, j_next
    return steps, rounds


def gsw_walk_pack(side: str, trace, values, diags=None, n_vec=None,
                  m_vec=None):
    """Walk and packing of one side's DP results (see
    ``gsw_walk_pack_reference``): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. The kernel's tile loads read whole
    aligned 16-byte words around the trace's rows, so ``trace`` must be
    its own allocation (as the DP wrappers return it), not a view into a
    larger one."""
    global walk_launches, local_walk_launches
    if side not in SIDES:
        raise ValueError(f"unknown walk side {side!r}")
    D, C, S = trace.shape
    dev = trace.device
    if dev.type == "cpu":
        return gsw_walk_pack_reference(side, trace, values, diags, n_vec,
                                       m_vec)
    left = side == "left"
    trace = expect(trace, torch.int8, (D, C, S), "trace", dev)
    values = expect(values, torch.int32, (C, S), "values", dev)
    if left:
        n_vec = expect(as_vec(n_vec, C, dev), torch.int32, (C,), "n_vec", dev)
        m_vec = expect(as_vec(m_vec, C, dev), torch.int32, (C,), "m_vec", dev)
    else:
        diags = expect(diags, torch.int32, (C, S), "diags", dev)
    P = -(-D // 4)
    meta = 20 if side == "local" else 12
    out = torch.empty((C, meta + P), dtype=torch.uint8, device=dev)
    if C == 0:
        return out
    lib = _kernels.lib("gsw_dp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsw_walk_pack_launch(
            trace.data_ptr(), values.data_ptr(),
            None if left else diags.data_ptr(),
            n_vec.data_ptr() if left else None,
            m_vec.data_ptr() if left else None, SIDES[side], C, S, D,
            out.data_ptr(), stream)
    _kernels.check(rc, "gsw_walk_pack")
    if side == "local":
        local_walk_launches += 1
    else:
        walk_launches += 1
    return out


def _routes_walk_order(ops: np.ndarray) -> list[list[CigarOp]]:
    """Run-length routes of the backward op codes, in walk order (not
    reversed: the graph traversal applies its own reversals)."""
    B, D = ops.shape
    stop = ops >= 3
    row_ends = np.where(stop.any(axis=1), stop.argmax(axis=1), D)
    col = np.arange(D)[None, :]
    valid = col < row_ends[:, None]
    change = np.ones((B, D), bool)
    change[:, 1:] = ops[:, 1:] != ops[:, :-1]
    change &= valid
    rows, starts = np.nonzero(change)
    routes: list[list[CigarOp]] = [[] for _ in range(B)]
    if len(rows) == 0:
        return routes
    run_ops = ops[rows, starts]
    ends = np.empty_like(starts)
    same_row = rows[:-1] == rows[1:]
    ends[:-1] = np.where(same_row, starts[1:], row_ends[rows[:-1]])
    ends[-1] = row_ends[rows[-1]]
    chars = "MID"
    for r, o, ln in zip(rows.tolist(), run_ops.tolist(),
                        (ends - starts).tolist()):
        routes[r].append(CigarOp(ln, chars[o]))
    return routes


@dataclass
class _Wave:
    """One wave in flight: its result rows on their way to the host."""

    result: DeviceResult
    n_left: int
    n_right: int
    d_left: int     # walk length n + m of the left side
    d_right: int


class GswDpBatch:
    """The left and right extension DPs of a wave of jobs, on ``device``.

    Results match the JAX ``GswDpBatch`` exactly: per left job (score,
    i_stop, j_stop) and its walk ops, per right job (score, max_i, max_j)
    and its walk ops.

    Job tensors are built at ``dims_for`` widths: lengths bucketed to
    multiples of 64 with a sticky per-side maximum, as the JAX class does
    (there to keep compiled shapes stable; here they fix the widths of
    the ops that callers read)."""

    def __init__(self, scores: np.ndarray, gap: int = -600, *, device=None):
        self.device = resolve_device(device)
        self.gap = gap
        self._scores_dev = torch.as_tensor(np.asarray(scores, np.int64),
                                           dtype=torch.int32,
                                           device=self.device)
        self._dims = {"left": [64, 64], "right": [64, 64]}  # sticky n, m

    @staticmethod
    def _bucket(x: int) -> int:
        return max(64, _round_up(x, 64))

    def dims_for(self, side: str, n: int, m: int) -> tuple[int, int]:
        """Grow this side's sticky dims to cover (n, m) and return them:
        callers build the side's job tensors at these widths."""
        dims = self._dims[side]
        dims[0] = max(dims[0], self._bucket(n))
        dims[1] = max(dims[1], self._bucket(m))
        return dims[0], dims[1]

    def _side(self, side: str, al, be, nv, mv) -> torch.Tensor:
        """(N, 12 + P) result rows of one side's jobs, on the device."""
        N = len(al)
        dev = self.device
        a = torch.from_numpy(np.ascontiguousarray(al, np.int8)).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(be, np.int8)).to(dev)
        nv = torch.from_numpy(np.asarray(nv, np.int32).reshape(N)).to(dev)
        mv = torch.from_numpy(np.asarray(mv, np.int32).reshape(N)).to(dev)
        if side == "left":
            _, _, trace, corner = local_wavefront(
                a, b, nv, mv, self._scores_dev, self.gap, with_corner=True)
            return gsw_walk_pack("left", trace, corner, n_vec=nv, m_vec=mv)
        bv, bd, trace = gsw_right_wavefront(a, b, nv, mv, self._scores_dev,
                                            self.gap)
        return gsw_walk_pack("right", trace, bv, bd)

    def start_wave(self, al_l, be_l, nv_l, mv_l, al_r, be_r, nv_r,
                   mv_r) -> _Wave | None:
        """Launch one wave: left jobs (al_l, be_l, nv_l, mv_l: int8 job
        tensors built at ``dims_for("left")`` widths, and the jobs'
        lengths) and right jobs likewise, and start the copy of their
        result rows to the host. Returns None for a wave without jobs.
        The widths are read from the tensors, not from the sticky dims,
        which another batch's thread may grow meanwhile."""
        nl, ml = al_l.shape[1], be_l.shape[1]
        nr, mr = al_r.shape[1], be_r.shape[1]
        Nl, Nr = len(al_l), len(al_r)
        if Nl == 0 and Nr == 0:
            return None
        lres = (self._side("left", al_l, be_l, nv_l, mv_l) if Nl else None)
        rres = (self._side("right", al_r, be_r, nv_r, mv_r) if Nr else None)
        width = 12 + max(-(-(nl + ml) // 4), -(-(nr + mr) // 4))
        rows = torch.zeros((Nl + Nr, width), dtype=torch.uint8,
                           device=self.device)
        if lres is not None:
            rows[:Nl, :lres.shape[1]] = lres
        if rres is not None:
            rows[Nl:, :rres.shape[1]] = rres
        return _Wave(DeviceResult(rows), Nl, Nr, nl + ml, nr + mr)

    @staticmethod
    def finish_wave(wave: _Wave | None):
        """(lmeta (Nl, 3) int32, lops (Nl, Dl) int8, rmeta (Nr, 3),
        rops (Nr, Dr)) of one ``start_wave``."""
        if wave is None:
            z3 = np.zeros((0, 3), np.int32)
            z = np.zeros((0, 0), np.int8)
            return z3, z, z3.copy(), z.copy()
        buf = wave.result.numpy()
        lbuf, rbuf = buf[:wave.n_left], buf[wave.n_left:]
        Dl, Dr = wave.d_left, wave.d_right
        return (np.ascontiguousarray(lbuf[:, :12]).view(np.int32),
                unpack_ops(lbuf[:, 12:12 + (Dl + 3) // 4], Dl),
                np.ascontiguousarray(rbuf[:, :12]).view(np.int32),
                unpack_ops(rbuf[:, 12:12 + (Dr + 3) // 4], Dr))
