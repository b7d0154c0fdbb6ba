"""The port's lowmem aligner end to end (gonomics_tpu_torch/ops/wavefront.py
`affine_gap_lowmem_batch` and `affine_gap_lowmem`, and
`align.pairwise.affine_gap_lowmem`) against the JAX package's, whose
Pallas kernels K6 and K7 run here in interpret mode: the shapes of
tests/test_lowmem_align.py and its batch case, then the pairwise API's
cigars. Exact equality of (score, ops, i0, j0) and of every cigar. The
port runs on the CPU (``device="cpu"``), which takes each kernel's plain
PyTorch version.
"""

import numpy as np
import pytest

from gonomics_tpu.align import pairwise as jax_pairwise
from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.align import pairwise as port_pairwise
from gonomics_tpu_torch.ops import wavefront as port_wf


def _assert_same(got, want):
    (gs, gops, gi, gj), (ws, wops, wi, wj) = got, want
    assert (gs, gi, gj) == (ws, wi, wj)
    assert isinstance(gs, int) and isinstance(gi, int) and isinstance(gj, int)
    assert gops.dtype == np.int8 and gops.ndim == 1
    np.testing.assert_array_equal(gops, np.asarray(wops))
    assert gi == 0 or gj == 0


@pytest.mark.parametrize("n,m,checkersize,seed", [
    (20, 20, 16, 0),
    (50, 90, 16, 1),
    (90, 50, 32, 2),
    (64, 64, 64, 3),    # single block
    (33, 71, 8, 4),     # many tiny blocks
    (1, 40, 16, 5),     # degenerate alpha
    (40, 1, 16, 6),     # degenerate beta
])
def test_lowmem_single_pair_matches_jax(n, m, checkersize, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(np.int8)
    b = rng.integers(0, 4, m).astype(np.int8)
    want = jax_wf.affine_gap_lowmem(a, b, HUMAN_CHIMP_TWO, -600, -150,
                                    checkersize=checkersize, interpret=True)
    got = port_wf.affine_gap_lowmem(a, b, HUMAN_CHIMP_TWO, -600, -150,
                                    checkersize=checkersize, device="cpu")
    _assert_same(got, want)


def test_lowmem_batch_matches_jax():
    """B pairs with different content, so different traceback corridors
    and windows, through one batched forward and backward."""
    rng = np.random.default_rng(21)
    B, n, m = 5, 70, 90
    alphas = rng.integers(0, 4, (B, n)).astype(np.int8)
    betas = rng.integers(0, 4, (B, m)).astype(np.int8)
    betas[2, :n] = alphas[2]
    want = jax_wf.affine_gap_lowmem_batch(alphas, betas, HUMAN_CHIMP_TWO,
                                          -600, -150, checkersize=16,
                                          interpret=True)
    got = port_wf.affine_gap_lowmem_batch(alphas, betas, HUMAN_CHIMP_TWO,
                                          -600, -150, checkersize=16,
                                          device="cpu")
    assert len(got) == B
    for g, w in zip(got, want):
        _assert_same(g, w)


def _related_pair():
    """The related pair of tests/test_lowmem_align.py (mutations and one
    indel), with N bases and negative codes added."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 120).astype(np.int8)
    b = a.copy()
    for p in rng.integers(0, 120, 6):
        b[p] = (b[p] + 1) % 4
    b = np.concatenate([b[:60], rng.integers(0, 4, 5).astype(np.int8),
                        b[60:]])
    a[[10, 70]] = 4
    a[5] = -3
    b[[20, 90]] = [-1, 4]
    return a, b


def test_pairwise_lowmem_matches_jax():
    a, b = _related_pair()
    want_score, want_route = jax_pairwise.affine_gap_lowmem(
        a, b, HUMAN_CHIMP_TWO, -600, -150, checkersize=32,
        backend="interpret")
    got_score, got_route = port_pairwise.affine_gap_lowmem(
        a, b, HUMAN_CHIMP_TWO, -600, -150, checkersize=32, device="cpu")
    assert got_score == want_score
    assert [(c.run_length, c.op) for c in got_route] == \
        [(c.run_length, c.op) for c in want_route]
    assert len(got_route) >= 3  # the insertion splits the route


@pytest.mark.parametrize("side", ["alpha", "beta"])
def test_pairwise_lowmem_rejects_codes_above_4(side):
    a, b = _related_pair()
    (a if side == "alpha" else b)[7] = 5
    with pytest.raises(ValueError, match=side):
        port_pairwise.affine_gap_lowmem(a, b, HUMAN_CHIMP_TWO, -600, -150,
                                        device="cpu")
