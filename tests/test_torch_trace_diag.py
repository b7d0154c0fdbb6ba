"""The schedule of the CUDA kernel trace_diag
(gonomics_tpu_torch/csrc/wavefront.cu), which serves the trace mode of
`affine_wavefront` and both modes of `const_wavefront`, emulated lane by
lane and held against the plain versions `affine_wavefront_reference` and
`const_wavefront_reference` (and, at one shape, against the JAX package's
`wavefront_align` in interpret mode); and the plan that picks its rows a
lane and warps a pair by shape.

The kernel cannot run here. The emulation repeats what each lane of each
warp does on every step, in int32 as the card computes: the R rows a lane,
the skew (row r of lane t at column c - tR - r + 1 on step c, all on
diagonal r0 + c + 2), the rotating shuffles of the upper neighbour (M, I,
D, or const's C) from lane t - 1 (lane 0 from lane 31, which sends the
strip before's last row, rebuilt from the boundary entry (max(M, I), 2 D +
(M >= I))), the trace codes of a step packed into the lane's R bytes of a
padded trace row and zeroed outside columns 1..m in the blocks that test
for it, the column-0 reset, the capture on the step of diagonal fin, the
zeros of lane 0 and of the diagonals a strip's steps do not reach, and the
ring row s mod W that strip s writes and strip s + 1 reads, with the W
warps of a pair run in a random order that each wait allows (the strip
before kDiagLag blocks ahead). The ring, the results and the trace rows
start with random junk, as torch.empty leaves them. Every comparison is
exact and covers every byte of the (n + m, B, n + 1) trace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch import NEG
from gonomics_tpu_torch.ops import wavefront as port_wf

GO, GE, GAP = -600, -150, -430
LAG = 34  # kDiagLag: the blocks a strip keeps ahead of the strip below it
LANE0 = 15  # the byte of lane 0 in a padded trace row


def _beta_row(code):
    """_select_score's row of a beta code (the kernel's lut)."""
    code = np.asarray(code, np.int64)
    return np.where(code < 2, np.where(code == 0, 0, 1), np.minimum(code, 4))


def _i32(x):
    return np.asarray(x).astype(np.int32)


def _argmax3(a, b, c):
    return np.where((a >= b) & (a >= c), 0, np.where(b >= c, 1, 2))


def _pitch(n: int) -> int:
    return 16 + -(-n // 16) * 16


class _Pair:
    """One pair of one launch: its codes, diagonal, scratch, result rows
    and padded trace rows, as the kernel's set-up leaves them."""

    def __init__(self, mode, al, be, f, sc, R, W, res, rows, rng):
        self.mode, self.al, self.be, self.f, self.sc = mode, al, be, int(f), sc
        self.n, self.m, self.R, self.W = len(al), len(be), R, W
        self.res, self.rows = res, rows
        self.affine, self.trace = mode == "affine", mode != "const_score"
        n, m = self.n, self.m
        self.ld = -(-max(m, 1) // R) * R  # stream_ld
        shape = (W, self.ld, 2) if self.affine else (W, self.ld)
        self.ring = rng.integers(-2**31, 2**31, shape).astype(np.int32)
        # every lane of the results NEG but row 0's cell (0, f)
        for r in res:
            r[:] = NEG
        if 1 <= self.f <= m:
            res[1 if self.affine else 0][0] = (GO + GE * self.f if self.affine
                                               else GAP * self.f)
        x = np.arange(self.ld)
        if self.affine:  # row 0: M = D = NEG, I = go + ge j
            iv = np.where(x < m, GO + GE * (x + 1), NEG)
            self.ring[W - 1, :, 0] = np.maximum(NEG, iv)
            self.ring[W - 1, :, 1] = (np.int32(NEG) << 1) | (NEG >= iv)
        else:
            self.ring[W - 1] = np.where(x < m, GAP * (x + 1), NEG)
        if self.trace:
            rows[:, :16] = 0
        self.progress = [0] * W


def _warp(pair, phase):
    """The strips of one warp, a generator that yields before each block
    of R steps (and before a strip's first boundary load) what it waits
    for: (warp, count), the progress word of that warp at least count, or
    None."""
    R, W, n, m, f, ld = pair.R, pair.W, pair.n, pair.m, pair.f, pair.ld
    affine, trace = pair.affine, pair.trace
    lanes = np.arange(32)
    goe = GO + GE
    strips = -(-n // (32 * R))
    s_last = strips - 1 if trace else (min(f, n) - 1) // (32 * R)
    res, rows = pair.res, pair.rows
    for s in range(phase, s_last + 1, W):
        r0 = s * 32 * R
        c_f = f - r0 - 2
        if not trace and c_f < 0:  # cell (f, 0), the strip's first row
            res[0][f] = GAP * f
            break
        i0 = r0 + lanes * R + 1
        last = r0 + 32 * R >= n
        c_end = m - 1 + (n - 1 - r0) if last else m + 32 * R - 2
        x_lo, x_hi = 16 + r0, 16 + min(r0 + 32 * R, -(-n // 16) * 16)
        if trace:  # diagonals 1..r0 + 1
            rows[:r0 + 1, x_lo:x_hi] = 0
        i = i0[:, None] + np.arange(R)
        a = np.where(i <= n, np.clip(pair.al[np.minimum(i, n) - 1], 0, 4), 4)
        prof = pair.sc[:, a].transpose(1, 0, 2)  # (lane, beta row, row)
        if affine:
            M = np.full((32, R), NEG, np.int32)
            I = M.copy()
            D = _i32(GO + GE * i)
            G = M.copy()
            G[:, 0] = max(0, GO) if r0 == 0 else GO + GE * r0
            T = np.zeros((32, R), np.int32)
            T[:, 0] = (_argmax3(0, GO, GO) if r0 == 0
                       else _argmax3(NEG, NEG, GO + GE * r0))
        else:
            C = _i32(GAP * i)
            G = np.full((32, R), NEG, np.int32)
            G[:, 0] = GAP * r0
        cb = np.zeros((32, R), np.int64)  # beta rows of the last R columns

        def codes(x0):
            """The beta codes of columns x0 + s + 1, 0 outside 1..m."""
            x = x0[:, None] + np.arange(R)
            inside = (x >= 0) & (x < m)
            return np.where(inside, pair.be[np.clip(x, 0, max(m - 1, 0))]
                            if m else 0, 0)

        bq = codes(-lanes * R)
        if trace and c_f == -1:  # cell (f, 0), on no step
            if affine:
                res[0][f], res[1][f], res[2][f] = NEG, NEG, GO + GE * f
            else:
                res[0][f] = GAP * f
        bin_, bout = pair.ring[(s + W - 1) % W], pair.ring[s % W]
        waits = W > 1 and s > 0
        before, tag = (phase + W - 1) % W, (s - 1) << 32
        yield (before, tag + LAG - 1) if waits else None
        bn = bin_[:R].copy()  # lane 31's boundary columns of the next block
        c_stop = c_end if trace or c_f > c_end else c_f
        nblk = 0 if c_stop < 0 else c_stop // R + 1
        feeds = s < s_last
        w_lo = 32 * R - 1 if feeds else 1 << 30
        k_f = c_f // R if 0 <= c_f <= c_stop else -1
        k_tail = m // R
        trow = r0 + 1  # the trace row of the next step's diagonal
        writes = i0 <= n
        for k in range(nblk):
            yield (before, tag + k + LAG) if waits else None
            edge = k < 32 or k >= k_tail or k == k_f or k == nblk - 1
            cn, bc = _beta_row(bq), bn.copy()
            bq = codes((k + 1 - lanes) * R)
            if (k + 1) * R < ld:
                bn = bin_[(k + 1) * R:(k + 2) * R].copy()
            done = False
            for st in range(R):
                c = k * R + st
                cb[:, (st + 1) % R] = cn[:, st]
                out = np.zeros((32, R), np.int32)
                inside = (c - lanes[:, None] * R - np.arange(R)
                          ).astype(np.int64)
                inside = (inside >= 0) & (inside < m)
                if affine:
                    sM, sI, sD = M[:, R - 1].copy(), I[:, R - 1].copy(), \
                        D[:, R - 1].copy()
                    h, y = bc[st]
                    sI[31], sM[31], sD[31] = h, h if y & 1 else h - 1, y >> 1
                    u0M, u0I, u0D = np.roll(sM, 1), np.roll(sI, 1), \
                        np.roll(sD, 1)
                    for r in range(R - 1, -1, -1):
                        if r:
                            uM, uI, uD = (M[:, r - 1].copy(), I[:, r - 1].copy(),
                                          D[:, r - 1].copy())
                        else:
                            uM, uI, uD = u0M, u0I, u0D
                        sub = prof[lanes, cb[:, (st + 1 - r) % R], r]
                        mv = _i32(sub + G[:, r])
                        md = M[:, r] >= D[:, r]
                        x = np.maximum(M[:, r], D[:, r])
                        iv = np.maximum(x + goe, GE + I[:, r])
                        ti = np.where(x + GO - np.where(md, 0, 1) >= I[:, r],
                                      np.where(md, 0, 2), 1)
                        mi = uM >= uI
                        uH = np.maximum(uM, uI)
                        dv = np.maximum(uH + goe, GE + uD)
                        td = np.where(uH + GO >= uD, np.where(mi, 0, 1), 2)
                        code = T[:, r] + 4 * ti + 16 * td
                        out[:, r] = np.where(inside[:, r], code, 0) \
                            if edge else code
                        G[:, r] = np.maximum(uH, uD)
                        T[:, r] = np.where(uH >= uD, np.where(mi, 0, 1), 2)
                        M[:, r], I[:, r], D[:, r] = mv, iv, dv
                    if 0 <= c - w_lo < m:
                        bout[c - w_lo] = (max(M[31, R - 1], I[31, R - 1]),
                                          (np.int32(D[31, R - 1]) << 1)
                                          | (M[31, R - 1] >= I[31, R - 1]))
                else:
                    sC = C[:, R - 1].copy()
                    sC[31] = bc[st]
                    u0 = np.roll(sC, 1)
                    for r in range(R - 1, -1, -1):
                        uC = C[:, r - 1].copy() if r else u0
                        sub = prof[lanes, cb[:, (st + 1 - r) % R], r]
                        dg, lf, up = _i32(G[:, r] + sub), C[:, r] + GAP, \
                            uC + GAP
                        code = _argmax3(dg, lf, up)
                        out[:, r] = np.where(inside[:, r], code, 0) \
                            if edge else code
                        G[:, r] = uC
                        C[:, r] = np.maximum(np.maximum(dg, lf), up)
                    if 0 <= c - w_lo < m:
                        bout[c - w_lo] = C[31, R - 1]
                if trace:
                    for t in np.nonzero(writes)[0]:
                        at = 16 + r0 + t * R
                        rows[trow, at:at + R] = out[t]
                    trow += 1
                if edge:
                    rr, t = (st + 1) % R, k + (st == R - 1)
                    if t < 32:  # the row that reached column 0
                        if affine:
                            M[t, rr] = I[t, rr] = NEG
                            D[t, rr] = GO + GE * (i0[t] + rr)
                        else:
                            C[t, rr] = GAP * (i0[t] + rr)
                    if c == c_f:
                        j = c - lanes[:, None] * R - np.arange(R) + 1
                        for t_, r_ in zip(*np.nonzero((i <= n) & (j >= 0)
                                                      & (j <= m))):
                            if affine:
                                res[0][i[t_, r_]] = M[t_, r_]
                                res[1][i[t_, r_]] = I[t_, r_]
                                res[2][i[t_, r_]] = D[t_, r_]
                            else:
                                res[0][i[t_, r_]] = C[t_, r_]
                    if c == c_stop:
                        done = True
                        break
            if feeds and W > 1:
                pair.progress[phase] = s << 32 | (k + 1)
            if done:
                break
        if feeds and W > 1:
            pair.progress[phase] = s << 32 | 0xffffffff
        if trace:  # the diagonals past the strip's last step
            rows[r0 + c_end + 2:, x_lo:x_hi] = 0


def emulate(mode, alpha, beta, fin, scores, R: int, W: int, seed: int = 0):
    """What trace_diag writes in ``mode`` ("affine", "const" or
    "const_score"): the (B, n + 1) result rows (rm, ri, rd; or res) and,
    in the trace modes, the (n + m, B, n + 1) view of the padded trace
    rows, each pair's W warps stepped a block at a time in a random order
    that their waits allow."""
    alpha, beta = np.asarray(alpha, np.int8), np.asarray(beta, np.int8)
    B, n = alpha.shape
    m = beta.shape[1]
    sc = np.asarray(scores, np.int32)
    rng = np.random.default_rng(seed)
    res = [rng.integers(-2**31, 2**31, (B, n + 1)).astype(np.int32)
           for _ in range(3 if mode == "affine" else 1)]
    rows = rng.integers(-128, 128, (n + m, B, _pitch(n))).astype(np.int8)
    for p in range(B):
        pair = _Pair(mode, alpha[p], beta[p], fin[p], sc, R, W,
                     [r[p] for r in res], rows[:, p], rng)
        if n == 0 or (mode == "const_score"
                      and not 1 <= pair.f <= n + m):
            continue
        warps = {w: _warp(pair, w) for w in range(W)}
        need = {w: None for w in warps}
        while warps:
            ready = [w for w in warps if need[w] is None
                     or pair.progress[need[w][0]] >= need[w][1]]
            assert ready, "every warp waits: the pipeline deadlocks"
            w = ready[rng.integers(len(ready))]
            try:
                need[w] = next(warps[w])
            except StopIteration:
                del warps[w]
    trace = rows[:, :, LANE0:LANE0 + n + 1] if mode != "const_score" else None
    return res, trace


def _batch(B: int, n: int, m: int, seed: int):
    """B pairs padded to (n, m): codes -1..6 in alpha and -2..5 in beta (a
    negative beta code scores as 1, a code above 4 as N) and code 4 past
    each pair's own n_b, m_b; fin = n_b + m_b, pair 0 at the full widths,
    pair 2 (with B > 2) of n_b = 0, one pair's fin 1 below its own and one
    (with B > 3) outside 1..n + m."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(-1, 7, (B, n)).astype(np.int8)
    beta = rng.integers(-2, 6, (B, m)).astype(np.int8)
    nb = rng.integers(1, max(n, 1) + 1, B)
    mb = rng.integers(1, max(m, 1) + 1, B)
    nb[0], mb[0] = n, m
    if B > 2:
        nb[2] = 0
    nb = np.minimum(nb, n)
    alpha[np.arange(n) >= nb[:, None]] = 4
    beta[np.arange(m) >= mb[:, None]] = 4
    fin = (nb + mb).astype(np.int32)
    if B > 1:
        fin[1] -= 1
    if B > 3:
        fin[3] = [0, n + m + 1][seed % 2]
    return alpha, beta, fin


def _reference(mode, alpha, beta, fin):
    args = (torch.from_numpy(alpha), torch.from_numpy(beta),
            torch.from_numpy(fin), torch.as_tensor(HUMAN_CHIMP_TWO))
    if mode == "affine":
        got = port_wf.affine_wavefront_reference(*args, GO, GE, True)
    else:
        got = port_wf.const_wavefront_reference(*args, GAP,
                                                mode == "const")
    got = got if isinstance(got, tuple) else (got,)
    return [g.numpy() for g in got]


# (mode, B, n, m, R, W): n not a multiple of a strip (32 R rows) with m <
# 32 R, one strip a warp in turn (W = 1), n below one strip, m < n, m = 1,
# n = 1, n = 0, more warps than strips, W = 5, and many strips with a
# small m (the shape of the card's 20,000-row case)
_CASES = [
    ("affine", 4, 70, 40, 2, 2), ("affine", 4, 70, 40, 2, 1),
    ("affine", 3, 20, 25, 4, 1), ("affine", 4, 150, 9, 2, 3),
    ("affine", 3, 30, 1, 2, 2), ("affine", 3, 1, 12, 2, 1),
    ("affine", 4, 0, 6, 2, 1), ("affine", 2, 200, 17, 4, 1),
    ("affine", 2, 130, 60, 4, 5), ("affine", 2, 600, 12, 4, 2),
    ("affine", 2, 1300, 5, 2, 4),
    ("const", 4, 70, 40, 2, 2), ("const", 3, 20, 25, 4, 1),
    ("const", 4, 150, 9, 2, 3), ("const", 3, 30, 1, 2, 2),
    ("const", 4, 0, 6, 2, 1), ("const", 2, 200, 17, 4, 1),
    ("const", 2, 130, 60, 4, 5), ("const", 2, 1300, 5, 2, 4),
    ("const_score", 4, 70, 40, 2, 2), ("const_score", 5, 150, 9, 2, 3),
    ("const_score", 3, 30, 1, 4, 1), ("const_score", 4, 0, 6, 2, 1),
    ("const_score", 4, 200, 17, 8, 2), ("const_score", 4, 130, 60, 4, 5),
    ("const_score", 2, 1300, 5, 2, 4)]


@pytest.mark.parametrize("mode,B,n,m,R,W", _CASES)
def test_emulation_equals_reference(mode, B, n, m, R, W):
    """The emulated kernel against the plain version: every result lane
    and every byte of the trace."""
    alpha, beta, fin = _batch(B, max(n, 1), m, seed=n + m + R + W)
    alpha = np.ascontiguousarray(alpha[:, :n])
    if n == 0:
        fin = np.minimum(fin, m + 1)
    got, trace = emulate(mode, alpha, beta, fin, HUMAN_CHIMP_TWO, R, W,
                         seed=W + R)
    want = _reference(mode, alpha, beta, fin)
    if trace is not None:
        got = got + [trace]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")


@pytest.mark.parametrize("mode", ["affine", "const"])
def test_emulation_equals_jax(mode):
    """At one small shape the emulated kernel equals the JAX
    wavefront_align (Pallas K2 or K3 in interpret mode): the result rows
    on lanes 0..n and every interior trace cell (the Pallas kernel writes
    its lane shift's junk elsewhere, which no walk reads)."""
    B, n, m = 3, 75, 33
    alpha, beta, fin = _batch(B, n, m, seed=7)
    alpha, beta = np.clip(alpha, 0, 4), np.clip(beta, 0, 4)
    go, ge = (GO, GE) if mode == "affine" else (GAP, 0)
    want = jax_wf.wavefront_align(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(fin[:, None]),
        HUMAN_CHIMP_TWO, n=n, m=m, gap_open=go, gap_extend=ge,
        with_trace=True, mode=mode, interpret=True)
    got, trace = emulate(mode, alpha, beta, fin, HUMAN_CHIMP_TWO, 2, 2,
                         seed=3)
    *res_want, trace_want = [np.asarray(x) for x in want]
    for g, w in zip(got, res_want):
        np.testing.assert_array_equal(g, w[:, :n + 1])
    d = np.arange(1, n + m + 1)[:, None, None]
    s = np.arange(n + 1)[None, None, :]
    interior = np.broadcast_to((s >= 1) & (d - s >= 1) & (d - s <= m),
                               trace.shape)
    np.testing.assert_array_equal(trace[interior],
                                  trace_want[:, :, :n + 1][interior])
    assert (trace[~interior] == 0).all()


# what trace_diag's library reports it is built for in each mode
# (trace_diag_built), written here so that the plan is checked without a
# card
_TRACE_BUILT = {mode: {"max_warps": 8, "pair_warps": 4, "rows_per_lane": rows}
                for mode, rows in (("affine", (2, 4)), ("const", (2, 4)),
                                   ("const_score", (2, 4, 8)))}


# (mode, B, n, m) -> (R, strips, W, warps a block, pairs a block, blocks):
# the pairwise phase's 128 pairs with trace (4 rows a lane, a warp a
# strip) and 256 in const's score mode (8 rows a lane, a warp a strip),
# the card's 20,000-row case (the most warps a block), enough pairs to
# fill the card (one warp a pair), a ragged last strip, one strip (a
# smaller R, or the trace modes' 4 above 64 rows) and no row
@pytest.mark.parametrize("mode,B,n,m,plan", [
    ("affine", 128, 1024, 1024, (4, 8, 8, 8, 1, 128)),
    ("const", 128, 1024, 1024, (4, 8, 8, 8, 1, 128)),
    ("const_score", 256, 1024, 1024, (8, 4, 4, 4, 1, 256)),
    ("affine", 2, 20_000, 300, (4, 157, 8, 8, 1, 2)),
    ("const_score", 2, 20_000, 300, (8, 79, 8, 8, 1, 2)),
    ("const", 2048, 1024, 1024, (4, 8, 1, 4, 4, 512)),
    ("const", 129, 260, 301, (4, 3, 3, 3, 1, 129)),
    ("affine", 5, 37, 50, (2, 1, 1, 4, 4, 2)),
    ("affine", 9, 100, 100, (4, 1, 1, 4, 4, 3)),
    ("const_score", 3, 0, 7, (2, 0, 1, 4, 4, 1))])
def test_trace_diag_plan(mode, B, n, m, plan):
    """trace_diag_plan by shape alone: stream_plan's rows a lane with 4 as
    the main count in the trace modes and 8 in const's score mode; one
    warp a pair where the pairs fill the card (2048 warps), else the
    fewest warps a pair that fill it, at most its strips and the 8 a block
    of trace_diag holds; a block of one pair's warps, or of 4 // W pairs
    below 4 warps."""
    assert port_wf.TRACE_ROWS_PER_LANE == 4
    got = port_wf.trace_diag_plan(B, n, m, mode, _TRACE_BUILT[mode])
    R, strips, W, warps, pairs, blocks = plan
    assert got == {"rows_per_lane": R, "strip_rows": 32 * R,
                   "strips": strips, "steps_a_strip": m + 32 * R - 1,
                   "warps_per_pair": W, "warps_per_block": warps,
                   "pairs_per_block": pairs, "blocks": blocks}


@pytest.mark.parametrize("mode,rows", [("affine", (2, 8)),
                                       ("const_score", (2, 4))])
def test_trace_diag_plan_needs_a_built_main(mode, rows):
    main = 4 if mode == "affine" else 8
    with pytest.raises(ValueError, match=f"not built for {main} rows"):
        port_wf.trace_diag_plan(128, 1024, 1024, mode,
                                {**_TRACE_BUILT[mode], "rows_per_lane": rows})
