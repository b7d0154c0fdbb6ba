"""The port's banded kernels (gonomics_tpu_torch/ops/banded.py) against
the JAX package's K1 (`_banded_kernel`, run in interpret mode), its
`_banded_walk` and `banded_align_full`, cell by cell.

Every value is int32, int8 or uint8, so every comparison is exact. The
port runs on CPU tensors here, which takes each kernel's plain PyTorch
version; the CUDA kernels are held against those same plain versions on
the card by tests/test_torch_card.py and by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as wf
from gonomics_tpu_torch.ops import banded

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
SCORINGS = {"humanChimp": (HUMAN_CHIMP_TWO, -600),
            "plusMinusOne": (PLUS_MINUS_ONE, -1)}


def _jax_banded_raw(reads, windows, n_vec, m_vec, scores, gap):
    """(bv, bi, trace) straight out of `_banded_kernel`: the pallas_call of
    wavefront.py:828-867, rebuilt here in interpret mode."""
    B, L = reads.shape
    W = windows.shape[1]
    BW = 64
    sc_t = jnp.asarray(scores, jnp.int32)
    wp = wf._round_up(W + 256 + 128, 128)
    bp = jnp.concatenate([jnp.asarray(windows),
                          jnp.full((B, wp - W), 4, jnp.int8)],
                         axis=1).astype(jnp.int32)
    bp = jnp.clip(bp, 0, 4)
    profs = []
    for a in range(5):
        lo = jnp.where(bp == 0, sc_t[a, 0], sc_t[a, 1])
        hi = jnp.where(bp == 2, sc_t[a, 2],
                       jnp.where(bp == 3, sc_t[a, 3], sc_t[a, 4]))
        profs.append(jnp.where(bp < 2, lo, hi))
    rcode = jnp.clip(jnp.asarray(reads).astype(jnp.int32), 0, 4).T[:, :, None]

    def vspec():
        return pl.BlockSpec(memory_space=pltpu.VMEM)

    kern = functools.partial(wf._banded_kernel, L=L, BW=BW, gap=gap, wp=wp)
    res = jax.ShapeDtypeStruct((B, BW), jnp.int32)
    bv, bi, _bc, trace = pl.pallas_call(
        kern, grid=(L,),
        in_specs=[vspec(), vspec(),
                  pl.BlockSpec((1, B, 1), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)] + [vspec()] * 5,
        out_specs=(vspec(), vspec(), vspec(),
                   pl.BlockSpec((1, B, BW), lambda i: (i, 0, 0),
                                memory_space=pltpu.VMEM)),
        out_shape=(res, res, res, jax.ShapeDtypeStruct((L, B, BW), jnp.int8)),
        scratch_shapes=[pltpu.VMEM((B, BW), jnp.int32)],
        interpret=True,
    )(jnp.asarray(n_vec), jnp.asarray(m_vec), rcode, *profs)
    return np.asarray(bv), np.asarray(bi), np.asarray(trace)


def _inputs(L: int, W: int, seed: int):
    """A batch of 8 (read, window) pairs: anchored reads with SNPs, a 5 bp
    deletion and insertion, short reads (n_b < L), lowercase and
    '-', '.', '*' codes (5-12), a short window (m_b < W) and a junk row."""
    rng = np.random.default_rng(seed)
    B = 8
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    n_vec = np.full((B, 1), L, np.int32)
    m_vec = np.full((B, 1), W, np.int32)
    off = min(8, W - L) if W > L else 0
    take = min(L, W - off)
    for b in range(6):
        reads[b, :take] = wins[b, off:off + take]
    reads[0, [5, L // 2]] = (reads[0, [5, L // 2]] + 1) % 4      # SNPs
    reads[1, L // 2:] = np.roll(reads[1, L // 2:], -5)           # deletion
    reads[2, L // 2 + 5:] = reads[2, L // 2:L - 5].copy()        # insertion
    n_vec[3, 0] = L - 13                                         # short read
    reads[3, L - 13:] = 4
    reads[4, ::7] += 5                                           # lowercase
    reads[4, 3] = 10
    reads[4, 9] = 11
    reads[4, 11] = 12
    wins[4, 1::9] += 5
    m_vec[5, 0] = W - 17                                         # short window
    n_vec[6, 0] = L // 3                                         # junk rows
    return reads, wins, n_vec, m_vec


CASES = [(L, W, name) for L in (40, 81) for W in (64, L + 48)
         for name in SCORINGS]


@pytest.mark.parametrize("L,W,scoring", CASES)
def test_banded_dp_matches_k1(L, W, scoring):
    scores, gap = SCORINGS[scoring]
    reads, wins, n_vec, m_vec = _inputs(L, W, seed=L + W)
    want = _jax_banded_raw(reads, wins, n_vec, m_vec, scores, gap)
    got = banded.banded_dp(torch.from_numpy(reads), torch.from_numpy(wins),
                           torch.from_numpy(n_vec), torch.from_numpy(m_vec),
                           scores, gap)
    for name, w, g in zip(("bv", "bi", "trace"), want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("L,W,scoring", CASES)
def test_banded_align_full_matches_jax(L, W, scoring):
    scores, gap = SCORINGS[scoring]
    reads, wins, n_vec, m_vec = _inputs(L, W, seed=L * W)
    want = wf.banded_align_full(jnp.asarray(reads), jnp.asarray(wins),
                                jnp.asarray(n_vec), jnp.asarray(m_vec),
                                scores, L=L, W=W, gap=gap, interpret=True)
    got = banded.banded_align_full(
        torch.from_numpy(reads), torch.from_numpy(wins),
        torch.from_numpy(n_vec), torch.from_numpy(m_vec), scores, gap)
    names = ("score", "i_end", "j_end", "i0", "j0", "packed")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (np.asarray(want[0]) > 0).any()


def test_banded_align_full_takes_first_max_lane():
    # two lanes of one read reach the same best score: the first wins
    L, W = 40, 64
    reads, wins, n_vec, m_vec = _inputs(L, W, seed=3)
    wins[7, :] = 0
    reads[7, :] = 0
    m_vec[7, 0] = W
    n_vec[7, 0] = 10
    bv, _, _ = banded.banded_dp(torch.from_numpy(reads),
                                torch.from_numpy(wins),
                                torch.from_numpy(n_vec),
                                torch.from_numpy(m_vec), PLUS_MINUS_ONE, -1)
    row = bv[7].numpy()
    assert (row == row.max()).sum() > 1
    got = banded.banded_align_full(
        torch.from_numpy(reads), torch.from_numpy(wins),
        torch.from_numpy(n_vec), torch.from_numpy(m_vec), PLUS_MINUS_ONE, -1)
    assert int(got[2][7] - got[1][7]) == int(np.argmax(row))


@pytest.mark.parametrize("seed", [0, 1])
def test_walk_pack_matches_jax_walk(seed):
    # random traces and start cells, inactive reads and reads that start
    # at row 0, through _banded_walk + the packing of wavefront.py:874-883
    rng = np.random.default_rng(seed)
    L, B = 30, 24
    D = banded.walk_length(L)
    trace = rng.choice(4, size=(L, B, 64), p=[0.6, 0.15, 0.15, 0.1])
    trace = trace.astype(np.int8)
    i_end = rng.integers(0, L + 1, B).astype(np.int32)
    c_end = rng.integers(0, 64, B).astype(np.int32)
    active = rng.random(B) < 0.8
    i0, c0, ops = wf._banded_walk(jnp.asarray(trace), jnp.asarray(i_end),
                                  jnp.asarray(c_end), jnp.asarray(active),
                                  D=D, BW=64)
    opsT = jnp.minimum(ops, 3).astype(jnp.int32)
    Dp = -(-D // 4) * 4
    opsT = jnp.pad(opsT, ((0, 0), (0, Dp - D)), constant_values=3)
    packed = (opsT.reshape(B, Dp // 4, 4)
              * jnp.asarray([1, 4, 16, 64], jnp.int32)).sum(
                  axis=-1).astype(jnp.uint8)
    got = banded.banded_walk_pack(torch.from_numpy(trace),
                                  torch.from_numpy(i_end),
                                  torch.from_numpy(c_end),
                                  torch.from_numpy(active), D)
    for name, w, g in zip(("i0", "c0", "packed"), (i0, c0, packed), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(
        banded.unpack_ops(got[2].numpy(), D),
        np.minimum(np.asarray(ops), 3).astype(np.int8))

