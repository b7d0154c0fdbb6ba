"""The tile walks of the CUDA kernels gsw_walk_pack
(gonomics_tpu_torch/csrc/gsw_dp.cu) and banded_walk_pack
(csrc/banded.cu), emulated lane by lane and held exactly against their
plain versions `gsw_walk_pack_reference` (its three sides) and
`banded_walk_pack_reference`; and `walk_rounds`, the steps and tiles
that chip_smoke.py reports, against the emulation's own count.

The kernels cannot run here. The emulation repeats what each lane of a
warp does: the right side's first-max (lanes striding over the bests,
then a butterfly of shuffles), the tile's corner at the current cell, each
lane's loads with the walk's clamps (the trace lies in a flat allocation
of junk bytes, and every aligned 16-byte chunk a lane loads must lie
inside it; the funnel shift of the unaligned rows) into the warp's tile
in shared memory, the steps taken with no test of the tile's edges (the
address each step moves must stay the cell's, inside the tile), the op
words kept a lane each and stored 32 at a time, the bulk fill of 3s and the meta written by the
lanes. The rows start as junk, and every byte of them must be written
exactly once. Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront
from test_torch_card import _graph_jobs

M32 = 0xFFFFFFFF


class _Memory:
    """An allocation of `size` junk bytes holding `data` at byte `base`."""

    def __init__(self, data: np.ndarray, base: int, size: int, rng):
        self.bytes = rng.integers(0, 256, size).astype(np.uint8)
        flat = data.reshape(-1).view(np.uint8)
        self.bytes[base:base + len(flat)] = flat
        self.base = base

    def chunk(self, addr: int) -> list:
        """The four words of the aligned 16-byte chunk at addr, which must
        lie inside the allocation."""
        assert addr % 16 == 0 and 0 <= addr and addr + 16 <= len(self.bytes)
        return [int(w) for w in self.bytes[addr:addr + 16].view("<u4")]

    def byte(self, addr: int) -> int:
        return int(self.bytes[addr])


def _funnel(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> sh) & M32


def _load_words(mem: _Memory, addr: int, NW: int) -> list:
    """load_words: NW / 4 aligned chunks (one in the kernel), one more if
    the bytes straddle a boundary, shifted by whole words and a funnel
    shift."""
    NQ = NW // 4
    q, off = addr & ~15, addr & 15
    v = []
    for k in range(NQ + 1):
        v += mem.chunk(q + 16 * k) if (k < NQ or off) else [0, 0, 0, 0]
    s, sh = off >> 2, 8 * (off & 3)
    return [_funnel(v[k + s], v[k + s + 1], sh) for k in range(NW)]


class _Row:
    """An output row of junk bytes, each written exactly once."""

    def __init__(self, n: int, rng):
        self.bytes = rng.integers(0, 256, n).astype(np.uint8)
        self.writes = np.zeros(n, np.int64)

    def put(self, k: int, v: int):
        self.bytes[k] = v & 0xFF
        self.writes[k] += 1


class _OpWords:
    """OpWords: each op enters the top bits of a word that moves down 2
    bits a step (a funnel shift), 16 ops a word, word g held by lane g mod
    32, the warp's 32 words stored at a time, every lane its own 4 bytes
    at `at`."""

    def __init__(self, row: _Row, at: int, P: int):
        self.row, self.at, self.P = row, at, P
        self.acc, self.held = 0, [0] * 32

    def _store(self, g0: int, g: int):
        for lane in range(32):
            gi = g0 + lane
            if gi > g:
                continue
            for k in range(4):
                if 4 * gi + k < self.P:
                    self.row.put(self.at + 4 * gi + k,
                                 self.held[lane] >> (8 * k))

    def push(self, t: int, op: int):
        self.acc = _funnel(self.acc, op, 2)
        if t & 15 == 15:
            g = t >> 4
            self.held[g & 31] = self.acc
            if g & 31 == 31:
                self._store(g - 31, g)

    def finish(self, t: int):
        g, m = t >> 4, t & 15
        self.held[g & 31] = (((self.acc >> (32 - 2 * m))
                              | (M32 << (2 * m))) & M32 if m else M32)
        self._store(g & ~31, g)
        for lane in range(32):
            for k in range(4 * (g + 1) + lane, self.P, 32):
                self.row.put(self.at + k, 0xFF)


def _first_max(vrow: np.ndarray, S: int):
    """The right side's warp-wide first-max: each lane's strict max over
    its lanes s = lane + 32 k, then a butterfly of __shfl_xor_sync."""
    best, arg = [-2**31] * 32, [S] * 32
    for lane in range(32):
        for s in range(lane, S, 32):
            if int(vrow[s]) > best[lane]:
                best[lane], arg[lane] = int(vrow[s]), s
    for k in (16, 8, 4, 2, 1):
        ob = [best[lane ^ k] for lane in range(32)]
        oa = [arg[lane ^ k] for lane in range(32)]
        for lane in range(32):
            if ob[lane] > best[lane] or (ob[lane] == best[lane]
                                         and oa[lane] < arg[lane]):
                best[lane], arg[lane] = ob[lane], oa[lane]
    assert len(set(best)) == 1 and len(set(arg)) == 1
    return best[0], arg[0]


def _clamp(x: int, lo: int, hi: int) -> int:
    return min(max(x, lo), hi)


def emulate_gsw(side: str, trace, values, diags, n_vec, m_vec, base: int,
                rng):
    """gsw_walk_pack_kernel<side> on every job: the (C, 12 + P) rows
    ((C, 20 + P) for the local side), and the steps that read a cell and
    the tiles loaded by each job's warp."""
    TD, TL = gsw_dp.GSW_TILE
    D, C, S = trace.shape
    P = -(-D // 4)
    meta = 20 if side == "local" else 12
    mem = _Memory(trace, base, base + trace.size, rng)
    out = np.zeros((C, meta + P), np.uint8)
    steps, rounds = np.zeros(C, np.int64), np.zeros(C, np.int64)
    left = side == "left"
    stop = side != "right"  # left and local: score > 0, stop on a 3
    for b in range(C):
        vrow = values[b]
        if left:
            i, j = int(n_vec[b]), int(m_vec[b])
            score = int(vrow[_clamp(i, 0, S - 1)])
        else:
            best, arg = _first_max(vrow, S)
            if best <= 0:
                score = i = j = 0
            else:
                score, i, j = best, arg, int(diags[b, arg]) - arg
        i_start, j_start = i, j
        row = _Row(meta + P, rng)
        ops = _OpWords(row, meta, P)
        tile = np.zeros(TD * TL, np.uint8)  # the warp's shared memory
        dtop, itop = 0, -TL
        t = 0
        live = (score > 0 and i > 0 and j > 0) if stop else (i > 0 or j > 0)
        while live and t < D:
            u = i + j - 1
            x, y = dtop - u, itop - i
            if not (0 <= x < TD and 0 <= y < TL):
                dtop, itop, x, y = u, i, 0, 0
                rounds[b] += 1
                lo = itop - TL + 1
                for lane in range(32):  # lane x loads diagonal dtop - x
                    dd = _clamp(dtop - lane, 0, D - 1)
                    rp = (dd * C + b) * S
                    if (lo >= 0 and itop <= S - 1
                            and not (dd == D - 1 and b == C - 1)):
                        words = _load_words(mem, base + rp + lo, 4)
                    else:
                        words = [sum(mem.byte(base + rp + _clamp(
                            lo + 4 * w + q, 0, S - 1)) << (8 * q)
                            for q in range(4)) for w in range(4)]
                    tile[lane * TL:(lane + 1) * TL] = np.array(
                        words, "<u4").view(np.uint8)
            n = min(min((TD - 1 - x) >> 1, TL - 1 - y) + 1, D - t)
            if not stop and j < 0:
                n = 1
            p = x * TL + (TL - 1 - y)
            for _ in range(n):
                # the address the steps moved is the cell's, in the tile
                cx, cy = dtop - (i + j - 1), itop - i
                assert 0 <= cx < TD and 0 <= cy < TL
                assert p == cx * TL + TL - 1 - cy
                code = int(tile[p])
                steps[b] += 1
                if stop and code == 3:
                    live = False
                    break
                i2, j2 = i - ((0x5 >> code) & 1), j - ((0x3 >> code) & 1)
                if not stop:
                    i2, j2 = max(i2, 0), max(j2, 0)
                p += (TL - 1) * (i - i2) + TL * (j - j2)
                i, j = i2, j2
                ops.push(t, code)
                t += 1
                live = (i > 0 and j > 0) if stop else (i > 0 or j > 0)
                if not live:
                    break
        ops.finish(t)
        fields = [score, *((i, j) if left else (i_start, j_start))]
        if side == "local":
            fields += [i, j]
        for lane in range(meta):
            row.put(lane, (fields[lane // 4] & M32) >> (8 * (lane % 4)))
        assert (row.writes == 1).all(), (side, b)
        out[b] = row.bytes
    return out, steps, rounds


def emulate_banded(trace, i_end, c_end, active, D: int, rng):
    """banded_walk_pack_kernel on every read: i0, c0
    and the (B, P) packed ops, and the steps that read a cell and the
    tiles entered by each read's warp."""
    L, B, _ = trace.shape
    P = -(-D // 4)
    base = 16 * int(rng.integers(0, 8))  # the wrapper's 16-byte alignment
    mem = _Memory(trace, base, base + trace.size, rng)
    i0, c0 = np.zeros(B, np.int32), np.zeros(B, np.int32)
    packed = np.zeros((B, P), np.uint8)
    steps, rounds = np.zeros(B, np.int64), np.zeros(B, np.int64)

    def load(b, top):
        rows = []
        for lane in range(32):
            r = _clamp(top - lane, 0, L - 1)
            rows.append(sum((mem.chunk(base + (r * B + b) * 64 + 16 * q)
                             for q in range(4)), []))
        return rows  # a lane's 16 words

    for b in range(B):
        i, c = int(i_end[b]), int(c_end[b])
        row = _Row(P, rng)
        ops = _OpWords(row, 0, P)
        tile = None  # the warp's shared memory, 32 rows of 64 bytes
        rtop = -1
        t = 0
        live = bool(active[b]) and i > 0
        while live and t < D:
            x = rtop - (i - 1)
            if not 0 <= x <= 31:
                rtop, x = i - 1, 0
                rounds[b] += 1
                tile = np.array(load(b, rtop), "<u4").view(
                    np.uint8).reshape(-1)
            n = min(32 - x, D - t)
            p = x * 64
            for _ in range(n):
                assert p == (rtop - (i - 1)) * 64 and 0 <= p < 2048
                code = int(tile[p + _clamp(c, 0, 63)])
                steps[b] += 1
                if code == 3:
                    live = False
                    break
                di = ~code & 1
                c += (code >> 1) - (code & 1)
                i -= di
                p += di * 64
                ops.push(t, code)
                t += 1
                if i == 0:
                    live = False
                    break
        ops.finish(t)
        assert (row.writes == 1).all(), b
        packed[b] = row.bytes
        i0[b], c0[b] = i, c
    return i0, c0, packed, steps, rounds


# ---------------------------------------------------------------------------
# the graph walk

def _check_gsw(side, trace, values, diags, nv, mv, base, rng):
    """The emulation against the plain version and walk_rounds."""
    args = [torch.from_numpy(np.ascontiguousarray(x)) if x is not None
            else None for x in (trace, values, diags, nv, mv)]
    want = gsw_dp.gsw_walk_pack_reference(side, *args).numpy()
    got, steps, rounds = emulate_gsw(side, trace, values, diags, nv, mv,
                                     base, rng)
    np.testing.assert_array_equal(got, want, err_msg=side)
    w_steps, w_rounds = gsw_dp.walk_rounds(side, *args)
    np.testing.assert_array_equal(steps, w_steps.numpy())
    np.testing.assert_array_equal(rounds, w_rounds.numpy())
    return want, steps, rounds


@pytest.mark.parametrize("base", [0, 5])
def test_gsw_tile_walk_on_real_traces(base):
    """Both sides on the plain DPs' traces at (n, m) = (70, 61) (D = 131,
    not a multiple of 4), 13 jobs (not a multiple of the 4 warps a
    block), among them an empty window, an empty read part and a job at
    (n, m) whose left walk starts on the trace's last row; the trace at
    offset 0 and at 5 (a view) of its allocation."""
    C, n, m = 13, 70, 61
    rng = np.random.default_rng(base)
    al, be, nv, mv = _graph_jobs(C, n, m, 7)
    args = (torch.from_numpy(al), torch.from_numpy(be), torch.from_numpy(nv),
            torch.from_numpy(mv), HUMAN_CHIMP_TWO, -600)
    _, _, ltrace, corner = wavefront.local_wavefront_reference(*args, True)
    bv, bd, rtrace = wavefront.gsw_right_wavefront_reference(*args)
    lw, _, lrounds = _check_gsw("left", ltrace.numpy(), corner.numpy(), None,
                                nv, mv, base, rng)
    _, _, rrounds = _check_gsw("right", rtrace.numpy(), bv.numpy(),
                               bd.numpy(), None, None, base, rng)
    assert (lw[:, :4].copy().view(np.int32) > 0).sum() > 0
    assert lrounds.max() >= 2 and rrounds.max() >= 2  # walks leave tiles
    # the local side on K4's own bests (local_align_full's walk)
    kbv, kbd, _ = wavefront.local_wavefront_reference(*args)
    kw, _, krounds = _check_gsw("local", ltrace.numpy(), kbv.numpy(),
                                kbd.numpy(), None, None, base, rng)
    assert (kw[:, :4].copy().view(np.int32) > 0).sum() > C // 2
    assert krounds.max() >= 2


def _junk_trace(name: str, rng):
    """A junk trace for both sides: codes 0-3 everywhere ("mixed", and
    "rare3" with long walks), or one code everywhere, whose walks leave
    their tiles through each edge ("all0": two diagonals and a lane a
    step; "all1": a diagonal; "all2": a diagonal and a lane)."""
    D, C, S = 67, 9, 40  # n = 39, m = 28
    probs = {"mixed": [0.55, 0.2, 0.2, 0.05], "rare3": [0.4, 0.29, 0.29, 0.02]}
    if name in probs:
        return rng.choice(4, size=(D, C, S), p=probs[name]).astype(np.int8)
    return np.full((D, C, S), int(name[-1]), np.int8)


def _junk_starts(rng, D: int, C: int, S: int):
    """Left starts (n_b, m_b, corner) and right bests (bv, bd): starts at
    lane 0 and S - 1, on diagonal 0 (i + j = 1), past the trace's last row
    and lane (the clamps), a left score <= 0 and a right max <= 0 (all
    bests < 0, and all 0), ties of the max (the first lane wins), and
    right starts whose j is negative."""
    n = S - 1
    nv = rng.integers(1, n + 1, C).astype(np.int32)
    mv = rng.integers(1, D - n + 1, C).astype(np.int32)
    corner = rng.integers(-5, 60, (C, S)).astype(np.int32)
    nv[0], mv[0] = n, D - n          # the trace's last row, job 0
    nv[1], mv[1] = 1, 1              # diagonal 1, a left walk's first
    nv[2], mv[2] = n + 5, D          # past the last lane and row
    nv[3] = 0                        # lane 0
    nv[-1], mv[-1] = n, D - n        # the allocation's last row
    corner[4, nv[4]] = 0             # a left score <= 0
    corner[5, nv[5]] = -3
    bv = rng.integers(-20, 40, (C, S)).astype(np.int32)
    bd = (np.arange(S)[None, :]
          + rng.integers(-3, D - n + 2, (C, S))).astype(np.int32)
    bv[0] = -1                       # max <= 0
    bv[1] = 0                        # max 0
    bv[2, :] = 7                     # a tie over every lane: lane 0
    bv[3, :] = 1
    bv[3, S - 1] = 9                 # lane S - 1
    bv[4, :] = 1
    bv[4, 5] = 9
    bd[4, 5] = 5                     # j = 0 at lane 5
    bv[5, :] = 1
    bv[5, 0] = 9
    bd[5, 0] = 1                     # (0, 1): diagonal 0
    bd[6] = np.arange(S) - 2         # j negative wherever the max is
    return nv, mv, corner, bv, bd


@pytest.mark.parametrize("name", ["mixed", "rare3", "all0", "all1",
                                  "all2"])
def test_gsw_tile_walk_on_junk_traces(name):
    """Both sides on a `_junk_trace` (right walks stall on a 3 or clamp at
    i = 0 or j = 0 without moving, left walks stop; walks leave their
    tiles through each edge) from the starts of `_junk_starts`."""
    rng = np.random.default_rng(len(name) + ord(name[-1]))
    trace = _junk_trace(name, rng)
    D, C, S = trace.shape
    nv, mv, corner, bv, bd = _junk_starts(rng, D, C, S)
    _check_gsw("left", trace, corner, None, nv, mv, 16, rng)
    _, rsteps, _ = _check_gsw("right", trace, bv, bd, None, None, 16, rng)
    assert rsteps.max() == D or name != "mixed"  # a right walk stalls
    # the local side from the right side's bests: the first max, a max
    # <= 0, starts past the last row and lane, j <= 0
    _check_gsw("local", trace, bv, bd, None, None, 16, rng)


def test_gsw_tile_walk_flushes_words():
    """A right side of D = 551 steps (past 32 words of ops, so the warp
    stores its words twice before the end), C = 5 jobs, on a trace of
    diagonal moves with rare left and up moves: walks of hundreds of steps
    over ten tiles and more, and one that stalls on a 3 at its start to the
    last step."""
    rng = np.random.default_rng(9)
    D, C, S = 551, 5, 301
    trace = rng.choice(3, size=(D, C, S), p=[0.9, 0.05, 0.05]).astype(np.int8)
    trace[549, 4, 300] = 3  # job 4 stalls at its start
    bv = np.zeros((C, S), np.int32)
    bd = np.zeros((C, S), np.int32)
    for b, (i, j) in enumerate([(300, 250), (200, 250), (290, 10), (1, 249),
                                (300, 250)]):
        bv[b, i] = 5
        bd[b, i] = i + j
    _, steps, rounds = _check_gsw("right", trace, bv, bd, None, None, 0, rng)
    assert steps.max() == D and rounds.max() >= 8


# ---------------------------------------------------------------------------
# the banded walk

def _check_banded(trace, i_end, c_end, active, D, rng):
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (trace, i_end, c_end, active)]
    want = [x.numpy() for x in banded.banded_walk_pack_reference(*args, D)]
    *got, steps, rounds = emulate_banded(trace, i_end, c_end, active, D, rng)
    for name, g, w in zip(("i0", "c0", "packed"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    w_steps, w_rounds = banded.walk_rounds(*args, D)
    np.testing.assert_array_equal(steps, w_steps.numpy())
    np.testing.assert_array_equal(rounds, w_rounds.numpy())
    return steps, rounds


def test_banded_tile_walk_on_real_traces():
    """The walk from banded_align_full's best cells on the plain DP's
    trace of 13 reads of 90 bp (not a multiple of the 8 warps a block; D =
    158, not a multiple of 16): walks over three tiles."""
    rng = np.random.default_rng(3)
    B, L, W = 13, 90, 138
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    reads = wins[:, 24:24 + L].copy()
    reads[rng.random((B, L)) < 0.03] = 1
    reads[3, 40:] = wins[3, 45:45 + L - 40]  # a 5 bp deletion
    reads[5] = rng.integers(0, 4, L)         # junk
    n_vec = np.full(B, L, np.int32)
    n_vec[7] = 50
    bv, bi, trace = banded.banded_dp_reference(
        torch.from_numpy(reads), torch.from_numpy(wins),
        torch.from_numpy(n_vec), torch.from_numpy(np.full(B, W, np.int32)),
        HUMAN_CHIMP_TWO, -600)
    score, i_star, c_star = banded.best_cell(bv, bi)
    steps, rounds = _check_banded(trace.numpy(), i_star.numpy(),
                                  c_star.numpy(), (score > 0).numpy(),
                                  banded.walk_length(L), rng)
    assert steps.max() > 64 and rounds.max() >= 3


@pytest.mark.parametrize("kind", ["mixed", "sideways", "code0", "code1",
                                  "code2"])
def test_banded_tile_walk_on_junk_traces(kind):
    """Random traces (codes 0-3; "sideways": mostly left or up moves that
    run past the band's columns, the column clamps) and traces of one code
    from starts at i_end = L, i_end 0, columns 0 and 63, inactive reads,
    and 21 reads (not a multiple of 8): walks that stop on a 3, at row 0,
    or run to the last step."""
    rng = np.random.default_rng(8)
    L, B = 70, 21
    D = banded.walk_length(L)
    i_end = rng.integers(0, L + 1, B).astype(np.int32)
    c_end = rng.integers(0, 64, B).astype(np.int32)
    active = rng.random(B) < 0.85
    i_end[:4] = L
    c_end[:4] = [0, 63, 0, 63]
    i_end[4], c_end[4] = 0, 30
    active[:4] = True
    if kind == "mixed":
        trace = rng.choice(4, size=(L, B, 64), p=[0.6, 0.15, 0.15, 0.1])
    elif kind == "sideways":
        trace = rng.choice(4, size=(L, B, 64), p=[0.3, 0.35, 0.34, 0.01])
    else:
        trace = np.full((L, B, 64), int(kind[-1]))
    _check_banded(trace.astype(np.int8), i_end, c_end, active, D, rng)
