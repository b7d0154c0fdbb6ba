"""The CUDA kernel of banded_dp (gonomics_tpu_torch/csrc/banded.cu) in its
two modes, emulated lane by lane and held exactly against the plain
versions: the trace mode against `banded_dp_reference`, the fused mode
against the plain `banded_align_full`; and `banded_plan`.

The kernel cannot run here. The emulation repeats what each thread of a
block does, all threads of all blocks as int32 arrays: the block's rows of
reads and windows staged from flat allocations of junk bytes (every
aligned 16-byte chunk a thread loads must lie inside the allocation's
16-byte words that hold the array), clipped four bytes at a time and
scattered to rows of shared memory that start as junk, with 4 where no
byte lands (every staged byte written once, every byte the rows read
written); then each row: the shuffles inside a read's segment of G = 64 /
R threads (a shuffle from outside the segment returns the thread's own
value), the sequential max-prefix over a thread's R lanes, the scan of the
totals, the exclusive value and the fix-up. The trace mode writes the
trace and the bests into junk buffers, every byte once; the fused mode
writes its 2-bit trace into shared memory, then finds the best cell by a
butterfly over the segment and walks and packs from the segment's first
thread, writing the six outputs into junk buffers, every byte once. Reads
past B in the last warp take part and store nothing. Every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu_torch.ops import banded

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
NEG_HALF = -(1 << 29)
BW = 64
BASE = 48  # the arrays' offset in their allocations (16-byte aligned)

# what the library reports for the H100 (banded_built), spilling nothing
BUILT = {"max_warps": 8, "smem_limit": 232336, "lanes_per_thread": (2, 4, 8),
         "registers": {2: (34, 34), 4: (40, 38), 8: (62, 60)},
         "spill_bytes": {2: (0, 0), 4: (0, 0), 8: (0, 0)}}


def _wrap(x):
    """int64 values as the int32 they wrap to."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


class _Buffer:
    """Junk bytes, each written exactly once by the kernel."""

    def __init__(self, n: int, rng):
        self.bytes = rng.integers(0, 256, n).astype(np.uint8)
        self.writes = np.zeros(n, np.int64)

    def put(self, addr, val):
        addr = np.asarray(addr).reshape(-1)
        self.bytes[addr] = np.asarray(val).reshape(-1) & 0xFF
        np.add.at(self.writes, addr, 1)

    def put_i32(self, index, val):
        """int32 values at int32 indices, little-endian."""
        index = np.asarray(index).reshape(-1)
        val = np.asarray(val, np.int64).reshape(-1) & 0xFFFFFFFF
        for k in range(4):
            self.put(4 * index + k, val >> (8 * k))

    def i32(self, n: int) -> np.ndarray:
        assert (self.writes == 1).all()
        return self.bytes[:4 * n].view("<i4").copy()


def _stage(g: np.ndarray, B: int, S: int, b0: int, RB: int, smem, writes,
           off: int, pitch: int, cols: int):
    """stage_rows: rows b0 .. b0 + RB - 1 of g (B, S), clipped, into rows
    of pitch bytes at off; 4 at columns >= S and rows >= B."""
    alloc = np.zeros(BASE + -(-g.size // 16) * 16 + 64, np.uint8) + 0xA5
    alloc[BASE:BASE + g.size] = g.reshape(-1).view(np.uint8)
    words_end = BASE + -(-g.size // 16) * 16
    nb = max(0, min(RB, B - b0))
    x = np.arange(RB * cols)
    r, q = x // cols, x % cols
    fill = (r >= nb) | (q >= S)
    addr = off + r[fill] * pitch + q[fill]
    smem[addr] = 4
    np.add.at(writes, addr, 1)
    if nb == 0:
        return
    s0, s1 = b0 * S, (b0 + nb) * S
    a0 = s0 & ~15
    for k in range((s1 - a0 + 15) >> 4):
        p = a0 + 16 * k
        assert (BASE + p) % 16 == 0 and BASE + p + 16 <= words_end
        chunk = np.clip(alloc[BASE + p:BASE + p + 16].view(np.int8), 0, 4)
        o = p - s0
        e0 = -o if o < 0 else 0
        r, q = divmod(o + e0, S)
        for e in range(e0, 16):
            if r >= nb:
                break
            if q < cols:
                smem[off + r * pitch + q] = chunk[e]
                writes[off + r * pitch + q] += 1
            q += 1
            if q == S:
                q, r = 0, r + 1


class _Lanes:
    """Shuffles of the (blocks, threads) arrays inside segments of G
    threads of a warp."""

    def __init__(self, T: int, G: int):
        x = np.arange(T)
        self.x, self.t, self.G = x, x % G, G

    def up(self, v, off):
        return v[:, np.where(self.t >= off, self.x - off, self.x)]

    def down(self, v, off):
        return v[:, np.where(self.t + off < self.G, self.x + off, self.x)]

    def xor(self, v, mask):
        return v[:, self.x ^ mask]


def emulate(reads, wins, n_vec, m_vec, scores, gap: int, R: int, WB: int,
            fused: bool, seed: int, codes: str = "staged"):
    """The kernel's launch at R lanes a thread and WB warps a block: the
    trace mode's (bv, bi, trace) or the fused mode's (score, i_end, j_end,
    i0, j0, packed). codes "global": the trace mode's variant that reads
    its codes from device memory, a thread's window codes shifted down a
    lane a row and one column loaded."""
    rng = np.random.default_rng(seed)
    B, L = reads.shape
    W = wins.shape[1]
    G, RW = BW // R, R // 2
    RB, T = WB * RW, 32 * WB
    NB = -(-B // RB)
    glob = codes == "global"
    assert not (glob and fused)
    pr, pw = banded._staged_pitch(L), banded._staged_pitch(L + BW)
    size = banded.smem_bytes(R, WB, L, fused, codes)
    assert size == (0 if glob else RB * (pr + pw + (16 * L if fused else 0)))
    smem = rng.integers(0, 256, (NB, size)).astype(np.int64)
    writes = np.zeros((NB, size), np.int64)
    if not glob:
        for blk in range(NB):
            _stage(reads, B, L, blk * RB, RB, smem[blk], writes[blk], 0, pr,
                   L)
            _stage(wins, B, W, blk * RB, RB, smem[blk], writes[blk],
                   RB * pr, pw, L + BW)
        staged = np.zeros(size, bool)
        rr = np.arange(RB)[:, None]
        staged[(rr * pr + np.arange(L)).reshape(-1)] = True
        staged[(RB * pr + rr * pw + np.arange(L + BW)).reshape(-1)] = True
        assert ((writes[:, staged] == 1).all()
                and (writes[:, ~staged] == 0).all())
    sc = np.asarray(scores, np.int64).reshape(-1)

    lanes = _Lanes(T, G)
    x = np.arange(T)
    t = x % G
    r = (x >> 5) * RW + (x & 31) // G
    blk = np.arange(NB)[:, None]
    b = blk * RB + r  # (NB, T)
    live = b < B
    bc = np.minimum(b, B - 1)
    n = np.where(live, n_vec.reshape(-1)[bc], 0).astype(np.int64)
    m = np.where(live, m_vec.reshape(-1)[bc], 0).astype(np.int64)
    tr_off = RB * (pr + pw) + r * 16 * L

    def lds(addr):
        assert (writes[np.broadcast_to(blk, addr.shape), addr] >= 1).all()
        return smem[np.broadcast_to(blk, addr.shape), addr]

    def global_code(g, S: int, q):
        """global_code: column q of row b of g (B, S), clipped; 4 at
        columns >= S and for reads past B."""
        q = q + 0 * b
        assert (q >= 0).all()
        load = live & (q < S)
        v = g[bc, np.minimum(q, S - 1)].astype(np.int64)
        return np.where(load, np.clip(v, 0, 4), 4)

    gc = [_wrap(gap * (t * R + k)) + 0 * b for k in range(R)]
    p = [np.zeros((NB, T), np.int64) for _ in range(R)]
    bv = [np.zeros((NB, T), np.int64) for _ in range(R)]
    bi = [np.zeros((NB, T), np.int64) for _ in range(R)]
    trace = _Buffer(L * B * BW, rng) if not fused else None
    wv = [global_code(wins, W, t * R + k - 1) if k else 4 + 0 * b
          for k in range(R)] if glob else None
    for i in range(1, L + 1):
        lim = np.where(i <= n, m, 0) - i - t * R
        if glob:
            wv = wv[1:] + [global_code(wins, W, i - 1 + t * R + R - 1)]
            rc = global_code(reads, L, i - 1 + 0 * t)
        else:
            rc = lds(r * pr + i - 1 + 0 * b)
        nxt = lanes.down(p[0], 1)
        nxt = np.where(t == G - 1, 0, nxt)
        s = np.full((NB, T), NEG_HALF, np.int64)
        diag, pre = [], []
        for k in range(R):
            w = (wv[k] if glob else
                 lds(RB * pr + r * pw + t * R + i - 1 + k + 0 * b))
            diag.append(_wrap(p[k] + sc[5 * rc + w]))
            up = p[k + 1] if k + 1 < R else nxt
            base = np.where(k <= lim, np.maximum(_wrap(up + gap), diag[k]),
                            NEG_HALF)
            s = np.maximum(s, _wrap(base - gc[k]))
            pre.append(s)
        off = 1
        while off < G:
            s = np.maximum(s, lanes.up(s, off))
            off *= 2
        excl = np.where(t == 0, NEG_HALF, lanes.up(s, 1))
        h = [np.where(k <= lim,
                      np.maximum(_wrap(np.maximum(pre[k], excl) + gc[k]), 0),
                      0) for k in range(R)]
        hl = np.where(t == 0, 0, lanes.up(h[R - 1], 1))
        code = []
        for k in range(R):
            left = _wrap((h[k - 1] if k else hl) + gap)
            code.append(np.where(h[k] == 0, 3, np.where(
                h[k] == diag[k], 0, np.where(h[k] == left, 1, 2))))
        if fused:
            bits = sum(code[k] << (2 * k) for k in range(R))
            row = tr_off + (i - 1) * 16 + 0 * b
            if R == 2:
                hi = lanes.down(bits, 1)
                sel = (t % 2 == 0) + 0 * b > 0
                addr, val = row[sel] + t[None].repeat(NB, 0)[sel] // 2, \
                    (bits | hi << 4)[sel]
            elif R == 4:
                addr, val = (row + t).reshape(-1), bits.reshape(-1)
            else:
                addr = np.concatenate([(row + 2 * t).reshape(-1),
                                       (row + 2 * t + 1).reshape(-1)])
                val = np.concatenate([bits.reshape(-1),
                                      (bits >> 8).reshape(-1)])
            blks = np.broadcast_to(blk, row.shape)
            if R == 2:
                blks = blks[sel]
            else:
                blks = np.tile(blks.reshape(-1), 1 if R == 4 else 2)
            smem[blks, addr] = val & 0xFF
            writes[blks, addr] += 1
        else:
            for k in range(R):
                trace.put(((i - 1) * B + b[live]) * BW + (t * R + k + 0 * b)[live],
                          code[k][live])
        for k in range(R):
            upd = h[k] > bv[k]
            bv[k] = np.where(upd, h[k], bv[k])
            bi[k] = np.where(upd, i, bi[k])
            p[k] = h[k]

    if not fused:
        bvo, bio = _Buffer(4 * B * BW, rng), _Buffer(4 * B * BW, rng)
        for k in range(R):
            idx = (b * BW + t * R + k)[live]
            bvo.put_i32(idx, bv[k][live])
            bio.put_i32(idx, bi[k][live])
        assert (trace.writes == 1).all()
        return (bvo.i32(B * BW).reshape(B, BW),
                bio.i32(B * BW).reshape(B, BW),
                trace.bytes.view(np.int8).reshape(L, B, BW))

    # fused: the best cell, a butterfly over the segment
    mv, mc, mi = bv[0].copy(), t * R + 0 * b, bi[0].copy()
    for k in range(1, R):
        upd = bv[k] > mv
        mv = np.where(upd, bv[k], mv)
        mc = np.where(upd, t * R + k, mc)
        mi = np.where(upd, bi[k], mi)
    off = 1
    while off < G:
        ov, oc, oi = lanes.xor(mv, off), lanes.xor(mc, off), lanes.xor(mi, off)
        take = (ov > mv) | ((ov == mv) & (oc < mc))
        mv, mc, mi = (np.where(take, ov, mv), np.where(take, oc, mc),
                      np.where(take, oi, mi))
        off *= 2
    D = banded.walk_length(L)
    P = -(-D // 4)
    outs = [_Buffer(4 * B, rng) for _ in range(5)]
    packed = _Buffer(B * P, rng)
    for q, y in zip(*np.nonzero(live & (t == 0))):
        bb = int(b[q, y])
        i, c, best = int(mi[q, y]), int(mc[q, y]), int(mv[q, y])
        # every thread of the segment agrees on the best cell
        seg = (b[q] == bb)
        assert (mv[q, seg] == best).all() and (mc[q, seg] == c).all()
        row = int(tr_off[y]) + (i - 1) * 16
        walking = best > 0
        for w in range(P):
            byte = 0xFF
            if walking:
                byte = 0
                for e in range(4):
                    code = 3
                    if walking and 4 * w + e < D:
                        cc = min(max(c, 0), BW - 1)
                        assert writes[q, row + (cc >> 2)] == 1
                        assert row == int(tr_off[y]) + (i - 1) * 16
                        code = (int(smem[q, row + (cc >> 2)]) >> (2 * (cc & 3))) & 3
                    if code == 3:
                        walking = False
                    else:
                        di = ~code & 1
                        c += (code >> 1) - (code & 1)
                        i -= di
                        row -= 16 * di
                        walking = i > 0
                    byte |= code << (2 * e)
            packed.put(bb * P + w, byte)
        for buf, v in zip(outs, (best, int(mi[q, y]), int(mi[q, y] + mc[q, y]),
                                 i, i + c)):
            buf.put_i32(bb, v)
    assert (packed.writes == 1).all()
    return (*(o.i32(B) for o in outs), packed.bytes.reshape(B, P))


def _inputs(B: int, L: int, W: int, seed: int):
    """Anchored reads with SNPs and indels, short reads and windows, reads
    and windows of length 0, codes 5-12 and negative codes, junk rows."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    off = max(0, min(8, W - L))
    take = min(L, W - off)
    reads[:, :take] = wins[:, off:off + take]
    reads[rng.random((B, L)) < 0.03] = 1
    ins = rng.random(B) < 0.2
    reads[ins, L // 2 + 3:] = reads[ins, L // 2:L - 3]
    reads[rng.random((B, L)) < 0.02] += 5                      # lowercase
    reads[rng.random((B, L)) < 0.01] = rng.integers(5, 13)     # '-', '.', '*'
    reads[rng.random((B, L)) < 0.01] = rng.integers(-128, 0)   # negative
    wins[rng.random((B, W)) < 0.01] = rng.integers(5, 13)
    wins[rng.random((B, W)) < 0.01] = -7
    n_vec = np.where(rng.random(B) < 0.25, rng.integers(0, L + 1, B), L)
    m_vec = np.where(rng.random(B) < 0.25, rng.integers(0, W + 1, B), W)
    junk = rng.random(B) < 0.15
    reads[junk] = rng.integers(0, 4, (int(junk.sum()), L))
    if B > 1:
        n_vec[1] = L // 3
    return reads, wins, n_vec.astype(np.int32), m_vec.astype(np.int32)


def _scoring(seed: int):
    return (HUMAN_CHIMP_TWO, -600) if seed % 2 else (PLUS_MINUS_ONE, -1)


SHAPES = [(B, L, W) for L in (40, 81, 150) for W in (64, L + 48)
          for B in (1, 3, 37)]


def _case(B, L, W, R):
    seed = B * 1000 + L + W + R
    scores, gap = _scoring(seed)
    plan = banded.banded_plan(B, L, BUILT, R=R)
    return seed, scores, gap, plan["warps_per_block"], _inputs(B, L, W, seed)


@pytest.mark.parametrize("R", (2, 4, 8))
@pytest.mark.parametrize("B,L,W", SHAPES)
def test_trace_mode_emulation(B, L, W, R):
    seed, scores, gap, WB, args = _case(B, L, W, R)
    got = emulate(*args, scores, gap, R, WB, False, seed)
    want = banded.banded_dp_reference(*(torch.from_numpy(a) for a in args),
                                      scores, gap)
    for name, g, w in zip(("bv", "bi", "trace"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("R", (2, 4, 8))
@pytest.mark.parametrize("B,L,W", SHAPES)
def test_fused_mode_emulation(B, L, W, R):
    seed, scores, gap, WB, args = _case(B, L, W, R)
    got = emulate(*args, scores, gap, R, WB, True, seed)
    want = banded.banded_align_full(*(torch.from_numpy(a) for a in args),
                                    scores, gap)
    names = ("score", "i_end", "j_end", "i0", "j0", "packed")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("R", (2, 4, 8))
@pytest.mark.parametrize("B,L,W", [(1, 40, 64), (3, 150, 198), (37, 81, 64),
                                   (37, 81, 129)])
def test_global_codes_emulation(B, L, W, R):
    # the trace mode's variant for reads whose codes do not fit shared
    # memory: windows shorter than L + 64 (columns past W read N), short
    # reads and windows, reads past B in the last warp
    seed, scores, gap, _, args = _case(B, L, W, R)
    WB = banded.banded_plan(B, L, BUILT, "dp", R=R,
                            codes="global")["warps_per_block"]
    got = emulate(*args, scores, gap, R, WB, False, seed, codes="global")
    want = banded.banded_dp_reference(*(torch.from_numpy(a) for a in args),
                                      scores, gap)
    for name, g, w in zip(("bv", "bi", "trace"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("WB", (1, 3, 8))
def test_emulation_at_forced_warps(WB):
    # blocks of other sizes: partial last blocks and warps past B
    B, L, W = 37, 81, 129
    for R in (2, 4, 8):
        for fused in (False, True):
            args = _inputs(B, L, W, WB + R)
            got = emulate(*args, HUMAN_CHIMP_TWO, -600, R, WB, fused, WB)
            tens = [torch.from_numpy(a) for a in args]
            want = (banded.banded_align_full if fused else
                    banded.banded_dp_reference)(*tens, HUMAN_CHIMP_TWO, -600)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())


def test_fused_equals_trace_mode_path():
    # the fused mode's walk over its 2-bit trace against the walk the
    # two-kernel path takes over the trace mode's int8 trace
    B, L, W = 37, 150, 198
    args = _inputs(B, L, W, 5)
    bv, bi, trace = emulate(*args, HUMAN_CHIMP_TWO, -600, 4, 4, False, 5)
    score, i_star, c_star = banded.best_cell(torch.from_numpy(bv),
                                             torch.from_numpy(bi))
    i0, c0, packed = banded.banded_walk_pack_reference(
        torch.from_numpy(trace), i_star, c_star, score > 0,
        banded.walk_length(L))
    got = emulate(*args, HUMAN_CHIMP_TWO, -600, 4, 4, True, 6)
    for g, w in zip(got, (score, i_star, i_star + c_star, i0, i0 + c0,
                          packed)):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[0] > 0).sum() > B // 2


@pytest.mark.parametrize("B,L,want", [
    (4096, 150, {"mode": "fused", "lanes_per_thread": 8,
                 "warps_per_block": 8, "reads_per_block": 32, "blocks": 128,
                 "smem_bytes": 32 * (320 + 320 + 2400)}),
    (1, 150, {"mode": "fused", "lanes_per_thread": 4, "warps_per_block": 1,
              "reads_per_block": 2, "blocks": 1}),
    (37, 81, {"mode": "fused", "lanes_per_thread": 4, "warps_per_block": 4,
              "reads_per_block": 8, "blocks": 5}),
    (4093, 150, {"mode": "fused", "lanes_per_thread": 8,
                 "warps_per_block": 8}),
    (4092, 150, {"mode": "fused", "lanes_per_thread": 4,
                 "warps_per_block": 8}),
    (2047, 150, {"mode": "fused", "lanes_per_thread": 4,
                 "warps_per_block": 8}),
    (2046, 150, {"mode": "fused", "lanes_per_thread": 4,
                 "warps_per_block": 4}),
    (64, 13000, {"mode": "dp", "lanes_per_thread": 2, "warps_per_block": 4,
                 "blocks": 16}),
    (1024, 13000, {"mode": "dp", "lanes_per_thread": 2,
                   "warps_per_block": 8, "blocks": 128}),
    (4096, 2000, {"mode": "fused", "lanes_per_thread": 8,
                  "warps_per_block": 1, "reads_per_block": 4}),
    (3, 13000, {"mode": "dp", "lanes_per_thread": 2, "warps_per_block": 3}),
    # past a block's shared memory at one warp: the codes in device memory
    (1, 120_000, {"mode": "dp", "codes": "global", "lanes_per_thread": 2,
                  "warps_per_block": 1, "blocks": 1, "smem_bytes": 0}),
    (4096, 120_000, {"mode": "dp", "codes": "global", "lanes_per_thread": 4,
                     "warps_per_block": 8, "blocks": 256}),
])
def test_banded_plan(B, L, want):
    plan = banded.banded_plan(B, L, BUILT)
    assert {k: plan[k] for k in want} == want
    assert plan["codes"] == ("global" if L > 116_000 else "staged")
    assert plan["smem_bytes"] == banded.smem_bytes(
        plan["lanes_per_thread"], plan["warps_per_block"], L,
        plan["mode"] == "fused", plan["codes"]) <= BUILT["smem_limit"]


def test_banded_plan_choices():
    # the trace mode's own lanes a thread; a spilling kernel is not
    # chosen; a mode and R can be forced; reads too long for one warp's
    # staged codes read them from device memory in the trace mode
    dp = banded.banded_plan(4096, 150, BUILT, "dp")
    assert (dp["mode"], dp["lanes_per_thread"], dp["warps_per_block"],
            dp["smem_bytes"]) == ("dp", 4, 8, 16 * (320 + 320))
    spill = {**BUILT, "spill_bytes": {**BUILT["spill_bytes"], 8: (0, 8)}}
    assert banded.banded_plan(4096, 150, spill)["lanes_per_thread"] == 4
    assert banded.banded_plan(4096, 150, BUILT, R=2)["reads_per_block"] == 8
    with pytest.raises(ValueError):
        banded.banded_plan(4096, 150, BUILT, R=16)
    far = banded.banded_plan(1, 200_000, BUILT)
    assert (far["mode"], far["codes"], far["lanes_per_thread"],
            far["warps_per_block"], far["smem_bytes"]) == ("dp", "global", 2,
                                                           1, 0)
    with pytest.raises(ValueError):
        banded.banded_plan(1, 200_000, BUILT, "fused")
    with pytest.raises(ValueError):
        banded.banded_plan(3, 13000, BUILT, "fused")
    # the longest reads the trace mode stages: one a block at 2 lanes
    near = banded.banded_plan(1, 116_000, BUILT)
    assert (near["mode"], near["codes"]) == ("dp", "staged")
    assert banded.banded_plan(1, 116_100, BUILT)["codes"] == "global"
    # the global codes can be forced, in the trace mode only
    forced = banded.banded_plan(4096, 150, BUILT, codes="global")
    assert (forced["mode"], forced["lanes_per_thread"],
            forced["warps_per_block"], forced["smem_bytes"]) == ("dp", 4, 8, 0)
    assert banded.banded_plan(64, 13000, BUILT, "dp", R=8, WB=8,
                              codes="global")["blocks"] == 2
    with pytest.raises(ValueError):
        banded.banded_plan(4096, 150, BUILT, "fused", codes="global")
    with pytest.raises(ValueError):
        banded.banded_plan(4096, 150, BUILT, codes="shared")
    # warps a block can be forced, and raise where they do not fit
    forced = banded.banded_plan(4096, 150, BUILT, "fused", R=2, WB=3)
    assert (forced["warps_per_block"], forced["reads_per_block"],
            forced["blocks"]) == (3, 3, 1366)
    with pytest.raises(ValueError):
        banded.banded_plan(64, 13000, BUILT, "dp", R=8, WB=8)
    with pytest.raises(ValueError):
        banded.banded_plan(64, 150, BUILT, WB=9)
