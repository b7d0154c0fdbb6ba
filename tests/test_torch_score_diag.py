"""The schedule of the CUDA kernel affine_score_diag
(gonomics_tpu_torch/csrc/wavefront.cu), which serves the score mode of
`affine_wavefront` and `wavefront_align_blocked`, emulated lane by lane
and held against the plain versions `affine_wavefront_reference` and
`affine_block_reference` (and, at one shape, against the JAX package's
`wavefront_align_blocked` in interpret mode); and the plan that picks its
rows a lane and warps a pair by shape.

The kernel cannot run here. The emulation repeats what each lane of each
warp does on every step, in int32 as the card computes: the R rows a lane,
the skew (row r of lane t at column c - tR - r + 1 on step c), the
rotating shuffle of (max(M, I), D) from lane t - 1 (lane 0 from lane 31,
which sends the strip before's last row), the column-0 reset, the capture
on the step of diagonal fin, the early stop, and the ring row s mod W that
strip s writes and strip s + 1 reads, with W warps of a pair run in a
random order that each wait allows (the strip before kDiagLag blocks
ahead). The scratch starts with random junk, as torch.empty leaves it.
Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch import NEG
from gonomics_tpu_torch.ops import wavefront as port_wf

GO, GE = -600, -150
LAG = 34  # kDiagLag: the blocks a strip keeps ahead of the strip below it


def _beta_row(code):
    """_select_score's row of a beta code (the kernel's lut)."""
    code = np.asarray(code, np.int64)
    return np.where(code < 2, np.where(code == 0, 0, 1), np.minimum(code, 4))


def _i32(x):
    return np.asarray(x).astype(np.int32)


class _Pair:
    """One pair of one launch: its codes, diagonal and scratch."""

    def __init__(self, al, be, f, sc, rows, R, W, rng):
        self.al, self.be, self.f, self.sc = al, be, int(f), sc
        self.n, self.m, self.rows, self.R, self.W = len(al), len(be), rows, R, W
        self.ld = -(-max(self.m, 1) // R) * R  # stream_ld
        # torch.empty's junk, then row 0 (M = D = NEG, I = go + ge j) in
        # ring row W - 1
        self.ring = rng.integers(-2**31, 2**31, (W, self.ld, 2)).astype(
            np.int32)
        x = np.arange(self.ld)
        self.ring[W - 1, :, 0] = np.where(x < self.m, GO + GE * (x + 1), NEG)
        self.ring[W - 1, :, 1] = NEG
        self.progress = [0] * W
        self.s_last = (min(self.f, rows) - 1) // (32 * R)


def _warp(pair, phase, put):
    """The strips of one warp, a generator that yields before each block
    of R steps (and before a strip's first boundary load) what it waits
    for: (warp, count), the progress word of that warp at least count, or
    None."""
    R, W, m, f, rows, ld = pair.R, pair.W, pair.m, pair.f, pair.rows, pair.ld
    lanes = np.arange(32)
    goe = GO + GE
    for s in range(phase, pair.s_last + 1, W):
        r0 = s * 32 * R
        c_f = f - r0 - 2
        if c_f < 0:  # cell (f, 0), the strip's first row, lane 0
            put(f, 0, GO + GE * f)
            break
        i0 = r0 + lanes * R + 1
        i = i0[:, None] + np.arange(R)
        a = np.where(i <= pair.n, np.clip(pair.al[np.minimum(i, pair.n) - 1],
                                          0, 4), 4)
        prof = pair.sc[:, a].transpose(1, 0, 2)  # (lane, beta row, row)
        M = np.full((32, R), NEG, np.int32)
        I = M.copy()
        D = _i32(GO + GE * i)
        G = M.copy()
        G[:, 0] = max(0, GO) if r0 == 0 else GO + GE * r0
        cb = np.zeros((32, R), np.int64)  # beta rows of the last R columns

        def codes(x0):
            """The beta codes of columns x0 + s + 1, 0 outside 1..m."""
            x = x0[:, None] + np.arange(R)
            inside = (x >= 0) & (x < m)
            return np.where(inside, pair.be[np.clip(x, 0, max(m - 1, 0))]
                            if m else 0, 0)

        bq = codes(-lanes * R)
        bin_, bout = pair.ring[(s + W - 1) % W], pair.ring[s % W]
        waits = W > 1 and s > 0
        before, tag = (phase + W - 1) % W, (s - 1) << 32
        yield (before, tag + LAG - 1) if waits else None
        bn = bin_[:R].copy()  # lane 31's boundary columns of the next block
        last = r0 + 32 * R >= rows
        c_end = m - 1 + (rows - 1 - r0) if last else m + 32 * R - 2
        cap = c_f <= c_end
        c_stop = c_f if cap else c_end
        nblk = c_stop // R + 1
        feeds = s < pair.s_last
        w_lo = 32 * R - 1 if feeds else 1 << 30
        for k in range(nblk):
            yield (before, tag + k + LAG) if waits else None
            edge = k < 32 or k == nblk - 1
            cn, bc = _beta_row(bq), bn.copy()
            bq = codes((k + 1 - lanes) * R)
            if (k + 1) * R < ld:
                bn = bin_[(k + 1) * R:(k + 2) * R].copy()
            done = False
            for st in range(R):
                c = k * R + st
                cb[:, (st + 1) % R] = cn[:, st]
                sH = np.maximum(M[:, R - 1], I[:, R - 1])
                sD = D[:, R - 1].copy()
                sH[31], sD[31] = bc[st]
                u0H, u0D = np.roll(sH, 1), np.roll(sD, 1)
                for r in range(R - 1, -1, -1):
                    if r:
                        uH, uD = np.maximum(M[:, r - 1], I[:, r - 1]), D[:, r - 1]
                    else:
                        uH, uD = u0H, u0D
                    sub = prof[lanes, cb[:, (st + 1 - r) % R], r]
                    mv = _i32(sub + G[:, r])
                    I[:, r] = np.maximum(np.maximum(M[:, r], D[:, r]) + goe,
                                         GE + I[:, r])
                    D[:, r] = np.maximum(uH + goe, GE + uD)
                    G[:, r] = np.maximum(uH, uD)
                    M[:, r] = mv
                if 0 <= c - w_lo < m:
                    bout[c - w_lo] = (max(M[31, R - 1], I[31, R - 1]),
                                      D[31, R - 1])
                if edge:
                    rr, t = (st + 1) % R, k + (st == R - 1)
                    if t < 32:  # the row that reached column 0
                        M[t, rr] = I[t, rr] = NEG
                        D[t, rr] = GO + GE * (i0[t] + rr)
                    if c == c_stop:
                        if cap:
                            best = np.maximum(np.maximum(M, I), D)
                            for t_, r_ in zip(*np.nonzero(
                                    (i <= rows) & (f - i >= 0)
                                    & (f - i <= m))):
                                put(i[t_, r_], f - i[t_, r_], best[t_, r_])
                        done = True
                        break
            if done:
                break
            if feeds and W > 1:
                pair.progress[phase] = s << 32 | (k + 1)
        if feeds and W > 1:
            pair.progress[phase] = s << 32 | 0xffffffff


def emulate(alpha, beta, fin, scores, rows: int, Rb: int, nb: int, R: int,
            W: int, seed: int = 0):
    """What affine_score_diag writes, (nb, B, Rb + 1) int32: diagonal fin_b
    of the score-mode DP over rows rows (alpha rows past n read code 4),
    each pair's W warps stepped a block at a time in a random order that
    their waits allow."""
    alpha, beta = np.asarray(alpha, np.int8), np.asarray(beta, np.int8)
    B = alpha.shape[0]
    m = beta.shape[1]
    sc = np.asarray(scores, np.int32)
    rng = np.random.default_rng(seed)
    out = np.full((nb, B, Rb + 1), NEG, np.int32)
    for p in range(B):
        f = int(fin[p])
        if 1 <= f <= m:
            out[0, p, 0] = GO + GE * f

        def put(i, j, v, p=p):
            k, x = divmod(int(i), Rb)
            if k < nb and (x or j):
                out[k, p, x] = v
            if x == 0 and k > 0:
                out[k - 1, p, Rb] = v

        pair = _Pair(alpha[p], beta[p], f, sc, rows, R, W, rng)
        if rows == 0 or f < 1 or f > rows + m:
            continue
        warps = {w: _warp(pair, w, put) for w in range(W)}
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
    return out


def _batch(B: int, n: int, m: int, seed: int):
    """B pairs padded to (n, m): codes -1..6 in alpha and -2..5 in beta (a
    negative beta code scores as 1, a code above 4 as N) and code 4 past
    each pair's own n_b, m_b; fin = n_b + m_b, pair 0 at the full widths,
    one pair's fin 1 below its own and one (with B > 3) outside
    1..n + m."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(-1, 7, (B, n)).astype(np.int8)
    beta = rng.integers(-2, 6, (B, m)).astype(np.int8)
    nb, mb = rng.integers(1, n + 1, B), rng.integers(1, m + 1, B)
    nb[0], mb[0] = n, m
    alpha[np.arange(n) >= nb[:, None]] = 4
    beta[np.arange(m) >= mb[:, None]] = 4
    fin = (nb + mb).astype(np.int32)
    if B > 1:
        fin[1] -= 1
    if B > 3:
        fin[3] = [0, n + m + 1][seed % 2]
    return alpha, beta, fin


def _blocked_reference(alpha, beta, fin, r_rows):
    return port_wf.affine_block_reference(
        torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(fin), torch.as_tensor(HUMAN_CHIMP_TWO), GO, GE,
        r_rows).numpy()


# (B, n, m, r_rows, R, W): r_rows not dividing n, n below one strip (32 R
# rows), m < n, m = 1, n = 1, several strips pipelined over 2 and 3 warps
# (more warps than strips in one), one strip a warp in turn (W = 1)
@pytest.mark.parametrize("B,n,m,r_rows,R,W", [
    (4, 70, 40, 24, 2, 2), (4, 70, 40, 24, 2, 1), (3, 20, 25, 8, 4, 1),
    (4, 150, 9, 40, 2, 3), (3, 30, 1, 7, 2, 2), (3, 1, 12, 4, 2, 1),
    (4, 300, 30, 128, 2, 3), (2, 200, 17, 64, 8, 1), (2, 130, 60, 50, 4, 5),
    (4, 600, 12, 256, 8, 2)])
def test_emulation_equals_blocked_reference(B, n, m, r_rows, R, W):
    """The emulated kernel against affine_block_reference on every lane of
    every row block, fin_b below, at and outside 1..n + m."""
    alpha, beta, fin = _batch(B, n, m, seed=n + m + R)
    nb = -(-n // r_rows)
    got = emulate(alpha, beta, fin, HUMAN_CHIMP_TWO, nb * r_rows, r_rows, nb,
                  R, W, seed=W)
    np.testing.assert_array_equal(got, _blocked_reference(alpha, beta, fin,
                                                          r_rows))


# (B, n, m, R, W): K2's score mode is one row block of n rows
@pytest.mark.parametrize("B,n,m,R,W", [
    (4, 90, 70, 2, 2), (4, 45, 120, 4, 1), (3, 100, 8, 2, 4),
    (2, 1, 1, 2, 1), (4, 0, 6, 2, 1), (3, 64, 1, 2, 2), (4, 260, 20, 8, 1)])
def test_emulation_equals_score_mode_reference(B, n, m, R, W):
    """The emulated kernel against affine_wavefront_reference's score mode
    on all n + 1 lanes."""
    alpha, beta, fin = _batch(B, max(n, 1), m, seed=n + 2 * m)
    alpha = alpha[:, :n]
    if n == 0:
        fin = np.array([m, m + 1, 0, 1][:B], np.int32)
    got = emulate(alpha, beta, fin, HUMAN_CHIMP_TWO, n, n, 1, R, W, seed=R)
    want = port_wf.affine_wavefront_reference(
        torch.from_numpy(alpha), torch.from_numpy(beta), torch.from_numpy(fin),
        torch.as_tensor(HUMAN_CHIMP_TWO), GO, GE, False).numpy()
    np.testing.assert_array_equal(got[0], want)


def test_emulation_equals_jax_blocked():
    """At one small shape the emulated kernel equals the JAX
    wavefront_align_blocked (Pallas K9 in interpret mode) on lanes
    0..r_rows; the JAX lanes above r_rows are NEG."""
    B, n, m, r_rows = 3, 70, 33, 24
    alpha, beta, fin = _batch(B, n, m, seed=5)
    alpha, beta = np.clip(alpha, 0, 4), np.clip(beta, 0, 4)
    want = np.asarray(jax_wf.wavefront_align_blocked(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(fin[:, None]),
        HUMAN_CHIMP_TWO, n=n, m=m, r_rows=r_rows, gap_open=GO, gap_extend=GE,
        interpret=True))
    nb = -(-n // r_rows)
    got = emulate(alpha, beta, fin, HUMAN_CHIMP_TWO, nb * r_rows, r_rows, nb,
                  2, 2, seed=1)
    np.testing.assert_array_equal(got, want[:, :, :r_rows + 1])
    assert (want[:, :, r_rows + 1:] == NEG).all()


# what affine_score_diag's library reports it is built for
# (affine_score_diag_built), written here so that the plan is checked
# without a card
_DIAG_BUILT = {"max_warps": 16, "pair_warps": 4, "rows_per_lane": (2, 4, 8)}


# (B, rows, m) -> (R, strips, W, warps a block, pairs a block, blocks): the
# score phase's 2048 pairs (one warp a pair), the main shapes' 256 pairs
# (a warp a strip), the lowmem batch and the 100 kb pair (the most warps a
# block), fills between, one strip (a smaller R) and no row
@pytest.mark.parametrize("B,rows,m,plan", [
    (2048, 1024, 1024, (8, 4, 1, 4, 4, 512)),
    (256, 1024, 1024, (8, 4, 4, 4, 1, 256)),
    (16, 16384, 16384, (8, 64, 16, 16, 1, 16)),
    (1, 100_000, 100_000, (8, 391, 16, 16, 1, 1)),
    (1024, 1024, 1024, (8, 4, 2, 4, 2, 512)),
    (683, 1024, 64, (8, 4, 3, 3, 1, 683)),
    (5, 300, 20, (8, 2, 2, 4, 2, 3)),
    (256, 100, 80, (4, 1, 1, 4, 4, 64)),
    (9, 40, 3, (2, 1, 1, 4, 4, 3)),
    (3, 0, 5, (2, 0, 1, 4, 4, 1))])
def test_score_diag_plan(B, rows, m, plan):
    """score_diag_plan by shape alone: stream_plan's rows a lane for rows
    rows; one warp a pair where the pairs fill the card (2048 warps), else
    the fewest warps a pair that fill it, at most its strips and 16; a
    block of one pair's warps, or of 4 // W pairs below 4 warps."""
    assert port_wf.SCORE_DIAG_FILL_WARPS == 2048
    got = port_wf.score_diag_plan(B, rows, m, _DIAG_BUILT)
    R, strips, W, warps, pairs, blocks = plan
    assert got == {"rows_per_lane": R, "strip_rows": 32 * R,
                   "strips": strips, "steps_a_strip": m + 32 * R - 1,
                   "warps_per_pair": W, "warps_per_block": warps,
                   "pairs_per_block": pairs, "blocks": blocks}


def test_score_diag_plan_needs_a_built_main():
    with pytest.raises(ValueError, match="not built for 8 rows"):
        port_wf.score_diag_plan(256, 1024, 1024, {**_DIAG_BUILT,
                                                  "rows_per_lane": (2, 4)})
