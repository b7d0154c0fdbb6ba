"""The port's lowmem kernels (gonomics_tpu_torch/ops/wavefront.py) one by
one against the JAX package's: the forward `_lowmem_fwd_loop` (Pallas K6
`_affine_fwd_chunked_kernel`), the windowed backward
`_affine_bwd_window_call` (Pallas K7 `_affine_bwd_window_kernel`), both in
interpret mode, and the block walk `_walk_block`.

Every value is int32 or int8, so every comparison is exact. The port runs
on CPU tensors here, which takes each kernel's plain PyTorch version; the
CUDA kernels are held against those same plain versions on the card by
tests/test_torch_card.py and by chip_smoke.py.

The JAX forward keeps its state in 8 sublane chunks of S8 / 8 lanes,
S8 = round_up(n + 1, 1024), in two parity slots (slot p holds the
diagonal d with d % 2 == p); `_port_checkpoints` maps that to the port's
(3, 2, B, n + 1) state of diagonals d0 - 1 and d0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import wavefront as port_wf

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
SCORINGS = {"humanChimp": (HUMAN_CHIMP_TWO, -600, -150),
            "plusMinusOne": (PLUS_MINUS_ONE, -1, -1)}


def _pairs(B: int, n: int, m: int, seed: int):
    """B pairs of n x m: pair 0 a relative of its alpha (SNPs, a gap,
    an N), the others random, one with N and negative codes."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 4, (B, n)).astype(np.int8)
    beta = rng.integers(0, 4, (B, m)).astype(np.int8)
    rel = np.resize(np.concatenate([alpha[0, :n // 3], alpha[0, n // 3 + 2:]]),
                    m)
    rel[rng.random(m) < 0.05] = rng.integers(0, 5)
    beta[0] = rel
    if B > 1:
        alpha[1, rng.integers(0, n, 2)] = [4, -2]
        beta[1, rng.integers(0, m, 2)] = [-1, 4]
    return alpha, beta


def _jax_forward(alpha, beta, scores, go, ge, K):
    """`_lowmem_fwd_loop` in interpret mode, set up as
    `affine_gap_lowmem_batch` (wavefront.py:1229-1264) sets it up."""
    B, n = alpha.shape
    m = beta.shape[1]
    S8 = (n + 1 + 1023) // 1024 * 1024
    Sc = S8 // 8
    fb = (n + m - 1) // K
    profiles, br = jax_wf._build_inputs(jnp.asarray(alpha), jnp.asarray(beta),
                                        scores, S8, m)
    width2 = (S8 + m + Sc + 256 + 127) // 128 * 128
    br2 = jnp.stack([br[:, c * Sc: c * Sc + width2] for c in range(8)],
                    axis=1)
    profs = [q.reshape(B, 8, Sc) for q in profiles]
    s_iota = jnp.arange(S8)
    neg = jnp.full((B, 8, Sc), jax_wf.NEG, jnp.int32)

    def rep(flat):
        return jnp.broadcast_to(flat.astype(jnp.int32).reshape(1, 8, Sc),
                                (B, 8, Sc))

    sm = jnp.stack([rep(jnp.where(s_iota == 0, 0, jax_wf.NEG)), neg])
    si = jnp.stack([rep(jnp.where(s_iota == 0, go, jax_wf.NEG)), neg])
    loop = jax_wf._lowmem_fwd_loop(B, Sc, n, m, K, fb, go, ge, True)
    return loop(jnp.full((1, 1), n + m, jnp.int32), br2, *profs, sm, si, si)


def _port_checkpoints(ck_m, ck_i, ck_d, K: int, n: int) -> np.ndarray:
    """JAX checkpoints (NB, 2, B, 8, Sc) in walk order (last block first),
    parity slots, as the port's (NB, 3, 2, B, n+1) in block order."""
    NB, _, B = ck_m.shape[:3]
    out = np.empty((NB, 3, 2, B, n + 1), np.int32)
    for r in range(NB):
        blk = NB - 1 - r
        d0 = blk * K
        for k, ck in enumerate((ck_m, ck_i, ck_d)):
            flat = np.asarray(ck[r]).reshape(2, B, -1)[:, :, :n + 1]
            out[blk, k, 0] = flat[(d0 - 1) % 2]
            out[blk, k, 1] = flat[d0 % 2]
    return out


@pytest.mark.parametrize("B,n,m,K", [
    (3, 50, 90, 16),    # several blocks
    (2, 33, 71, 7),     # K odd and not dividing n + m
    (2, 40, 24, 64),    # a single block
    (1, 1, 19, 4),      # n = 1
])
def test_forward_matches_jax(B, n, m, K):
    go, ge = -600, -150
    alpha, beta = _pairs(B, n, m, seed=n + K)
    ck_m, ck_i, ck_d, resm, resi, resd, fm, fi, fd = _jax_forward(
        alpha, beta, HUMAN_CHIMP_TWO, go, ge, K)
    ck, cap = port_wf.lowmem_forward(torch.from_numpy(alpha),
                                     torch.from_numpy(beta), HUMAN_CHIMP_TWO,
                                     go, ge, K)
    want = _port_checkpoints(ck_m, ck_i, ck_d, K, n)
    assert ck.dtype == torch.int32 and tuple(ck.shape) == want.shape
    np.testing.assert_array_equal(ck.numpy(), want)
    for k, res in enumerate((resm, resi, resd)):
        np.testing.assert_array_equal(
            cap[k].numpy(), np.asarray(res).reshape(B, -1)[:, :n + 1])
    for k, f in enumerate((fm, fi, fd)):
        np.testing.assert_array_equal(cap[k, :, n].numpy(), np.asarray(f))


def test_forward_block_without_fin_captures_neg():
    """The capture is reset to NEG at each block's start: a block that
    does not reach diagonal fin returns NEG on every lane."""
    alpha, beta = _pairs(2, 20, 30, seed=1)
    state = port_wf.initial_state(2, 20, -600, "cpu")
    _, cap = port_wf.affine_fwd_block(torch.from_numpy(alpha),
                                      torch.from_numpy(beta), state, 0, 50,
                                      HUMAN_CHIMP_TWO, -600, -150, 16)
    assert (cap == port_wf.NEG).all()


# (B, n, clusters of 8 / of 7 / of 6 or fewer blocks the card holds at
# once, CL): bench.py's 16 pairs of 16,384^2 when 16 clusters of 8 fit,
# when 15 do (an H100 80GB HBM3 at one block an SM) and when neither 8 nor
# 7 fits; the 100 kb pair; blocks that would keep fewer than 1024 lanes;
# and pairs that outnumber every cluster size
@pytest.mark.parametrize("B,n,resident,CL", [
    (16, 16384, (16, 17, 20), 8), (16, 16384, (15, 17, 20), 7),
    (16, 16384, (15, 15, 20), 6), (1, 100_000, (15, 17, 20), 8),
    (3, 2046, (15, 17, 20), 1), (3, 2048, (15, 17, 20), 2),
    (3, 3072, (15, 17, 20), 3), (3, 40, (15, 17, 20), 1),
    (200, 16384, (15, 17, 66), 1), (16, 16384, (0, 0, 0), 1)])
def test_fwd_cluster_size(B, n, resident, CL):
    """affine_fwd_block's cluster size from the pair count, the lanes and
    the clusters the card holds (a query on the card, given here)."""
    def held(c):
        return resident[0] if c == 8 else resident[1] if c == 7 else resident[2]

    assert port_wf.fwd_cluster_size(B, n, held) == CL
    lanes = port_wf.fwd_block_lanes(n, CL)
    assert lanes * CL >= n and (lanes - 1) * CL < n
    if CL > 1:
        assert lanes >= port_wf.FWD_MIN_LANES
    # at full width a block of a cluster of 8 keeps its state in shared
    # memory; the 100 kb pair's blocks keep theirs in a global scratch
    assert port_wf.state_in_shared_memory(lanes, "affine") == (
        n * 9 * 4 // CL < port_wf.SMEM_STATE_BYTES_MAX)


# What affine_bwd_window's library reports it is built for
# (``_bwd_built`` on the card, given here).
_BWD_BUILT = {"max_warps": 16, "max_cluster": 8, "lanes": (2, 4, 8)}


# (B, W, clusters the card holds at once at CL = 8 / 7 / fewer, L, CL):
# bench.py's 16 windows of 2,688 lanes (K = 1024) when 16 clusters of 8
# fit (8 blocks of 6 strips would leave the last without one: 7 of 6) and
# when only 15 do; the 100 kb pair's 8,832 lanes (K = 4096), which need 4
# lanes a thread to fit 8 blocks of 16 strips; a window of 41 lanes (n =
# 40), one strip; more pairs than the card holds clusters of any size
# (the smallest that fits 16 strips a block, in waves); and windows too
# wide for 8 blocks even at 8 lanes a thread (K = 16,384: the kernel
# sweeps them in passes, at the largest cluster the card holds at once,
# or at one block a pair in waves)
@pytest.mark.parametrize("B,W,resident,L,CL", [
    (16, 2688, (30, 30, 30), 2, 7), (16, 2688, (15, 20, 20), 2, 7),
    (16, 2688, (15, 15, 20), 2, 6), (1, 8832, (15, 17, 20), 4, 8),
    (3, 41, (15, 17, 20), 2, 1), (200, 2688, (15, 17, 66), 2, 3),
    (16, 40_000, (15, 17, 20), 8, 7), (1, 33_408, (15, 17, 20), 8, 8),
    (200, 40_000, (15, 17, 66), 8, 1)])
def test_bwd_cluster_size(B, W, resident, L, CL):
    """affine_bwd_window's lanes a thread and cluster size from the pair
    count, the window, what the kernel is built for and the clusters the
    card holds (queries on the card, given here)."""
    def held(c):
        return resident[0] if c == 8 else resident[1] if c == 7 else resident[2]

    assert port_wf.bwd_lanes_per_thread(W, _BWD_BUILT) == L
    assert port_wf.bwd_cluster_size(B, W, L, _BWD_BUILT, held) == CL
    strips = -(-W // (32 * L))
    warps = -(-strips // CL)
    assert (CL - 1) * warps < strips  # every block has a strip
    one_pass = strips <= 8 * 16
    assert (warps <= 16) == one_pass
    if one_pass:
        assert L == min(x for x in (2, 4, 8) if 8 * 16 * 32 * x >= W)


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_backward_window_matches_jax(scoring):
    """K7 on a window with wlo > 0 (and one pair at wlo = 0): every
    interior cell's trace code equals the Pallas kernel's, given the same
    wlo and W, including the cells at the window's left edge that read
    their own lane as the s-1 neighbour."""
    scores, go, ge = SCORINGS[scoring]
    B, n, m, K, d0 = 3, 900, 300, 8, 400
    alpha, beta = _pairs(B, n, m, seed=len(scoring))
    at, bt = torch.from_numpy(alpha), torch.from_numpy(beta)
    # the checkpoint at d0, from the port's forward (held to the JAX
    # forward by test_forward_matches_jax)
    state, _ = port_wf.affine_fwd_block(
        at, bt, port_wf.initial_state(B, n, go, "cpu"), 0, n + m, scores, go,
        ge, d0)
    i = torch.tensor([150, 300, 399], dtype=torch.int32)
    trace, wlo = port_wf.affine_bwd_window(at, bt, state, d0, i, scores, go,
                                           ge, K)
    W = port_wf.window_width(n, K)
    assert W == 768 < n + 1
    assert wlo.tolist() == [0, 128, 128]
    assert trace.dtype == torch.int8 and tuple(trace.shape) == (K, B, W)

    # the JAX kernel, given the same windows, sliced as `_lowmem_backward`
    # slices them (wavefront.py:1153-1169)
    S8 = 1024
    profiles, br = jax_wf._build_inputs(jnp.asarray(alpha), jnp.asarray(beta),
                                        scores, S8, m)
    brp = np.pad(np.asarray(br), ((0, 0), (K, 0)), constant_values=4)
    w0 = wlo.numpy()
    Wsl = K + W + 256
    y0 = m + S8 + w0 - d0
    br_sl = np.stack([brp[b, y0[b]:y0[b] + Wsl] for b in range(B)])
    qs = [np.stack([np.asarray(q)[b, w0[b]:w0[b] + W] for b in range(B)])
          for q in profiles]
    windows = []
    for k in range(3):
        slots = np.empty((2, B, W), np.int32)
        for p, d in ((0, d0 - 1), (1, d0)):
            full = state[k, p].numpy()
            slots[d % 2] = np.stack([full[b, w0[b]:w0[b] + W]
                                     for b in range(B)])
        windows.append(jnp.asarray(slots))
    bwd = jax_wf._affine_bwd_window_call(B, W, n=n, m=m, gap_open=go,
                                         gap_extend=ge, s_size=S8, K=K,
                                         interpret=True)
    want = np.asarray(bwd(jnp.full((1, 1), d0, jnp.int32),
                          jnp.asarray(w0[:, None]), jnp.asarray(br_sl),
                          *[jnp.asarray(q) for q in qs], *windows))
    d = d0 + 1 + np.arange(K)[:, None, None]
    s = w0[None, :, None] + np.arange(W)[None, None, :]
    interior = (s >= 1) & (s <= n) & (d - s >= 1) & (d - s <= m)
    assert interior[:, 1, 0].all()  # the window's left edge is interior
    got = trace.numpy()
    np.testing.assert_array_equal(got[interior], want[interior])
    assert (got[~interior] == 0).all()


def _walk_inputs(seed: int):
    rng = np.random.default_rng(seed)
    K, B, W, d0 = 16, 6, 40, 30
    trace = rng.integers(0, 64, (K, B, W)).astype(np.int8)
    wlo = rng.integers(0, 20, B).astype(np.int32)
    # cells on the block's diagonals, on its first, on the one before
    # it, on row 0 and column 0, and an unknown state 3
    i = np.array([20, 25, 1, 20, 0, 22], np.int32)
    j = np.array([26, 21, 30, 10, 40, 24], np.int32)
    k = np.array([0, 1, 2, 0, 1, 3], np.int32)
    return trace, wlo, d0, i, j, k


def test_walk_block_matches_jax():
    trace, wlo, d0, i, j, k = _walk_inputs(4)
    K, B, W = trace.shape
    wi, wj, wk, wops = jax_wf._walk_block(
        jnp.asarray(trace), d0, jnp.asarray(wlo), jnp.asarray(i),
        jnp.asarray(j), jnp.asarray(k), K=K, W=W)
    ti, tj, tk = (torch.from_numpy(x.copy()) for x in (i, j, k))
    ops = port_wf.lowmem_walk_block(torch.from_numpy(trace),
                                    torch.from_numpy(wlo), d0, ti, tj, tk)
    assert ops.dtype == torch.int8 and tuple(ops.shape) == (K, B)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(wops))
    for got, want in ((ti, wi), (tj, wj), (tk, wk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (ops.numpy() == 4).any() and (ops.numpy() < 3).any()


def test_walk_block_on_real_trace_matches_jax():
    """The walk over a K7 trace from the last block of a real pair, from
    (n, m) in the start state that the capture picks."""
    go, ge, K = -600, -150, 16
    alpha, beta = _pairs(2, 60, 70, seed=8)
    at, bt = torch.from_numpy(alpha), torch.from_numpy(beta)
    ck, cap = port_wf.lowmem_forward(at, bt, HUMAN_CHIMP_TWO, go, ge, K)
    k0 = port_wf._argmax3(*cap[:, :, 60]).to(torch.int32)
    d0 = (ck.shape[0] - 1) * K
    i = torch.full((2,), 60, dtype=torch.int32)
    j = torch.full((2,), 70, dtype=torch.int32)
    trace, wlo = port_wf.affine_bwd_window(at, bt, ck[-1], d0, i,
                                           HUMAN_CHIMP_TWO, go, ge, K)
    W = trace.shape[2]
    wi, wj, wk, wops = jax_wf._walk_block(
        jnp.asarray(trace.numpy()), d0, jnp.asarray(wlo.numpy()),
        jnp.asarray(i.numpy()), jnp.asarray(j.numpy()),
        jnp.asarray(k0.numpy()), K=K, W=W)
    ops = port_wf.lowmem_walk_block(trace, wlo, d0, i, j, k0)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(wops))
    for got, want in ((i, wi), (j, wj), (k0, wk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
