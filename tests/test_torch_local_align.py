"""The port's `local_align_full` (gonomics_tpu_torch/ops/wavefront.py, the
read aligner's mesh path: K4 over each pair's whole grid, then the best
cell, the walk and the packing) against the JAX package's
`local_align_full` (gonomics_tpu/ops/wavefront.py:649), whose Pallas K4
runs here in interpret mode; and the walk's plain version, the local side
of `gsw_walk_pack_reference`, on the JAX K4's own bests and trace.

Every value is an integer, so every comparison is exact: all six outputs
(score, i_end, j_end, i0, j0 and the packed ops). The port runs on CPU
tensors, which takes the plain versions; the CUDA kernels are held
against those same plain versions on the card by tests/test_torch_card.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import gsw_dp as port_dp
from gonomics_tpu_torch.ops import wavefront as port_wf

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int64)
# ties everywhere: a match and a mismatch score alike, as do the gaps
FLAT = np.where(np.eye(5, dtype=bool), 2, 0).astype(np.int64)
SCORINGS = {"humanChimp": (HUMAN_CHIMP_TWO, -600),
            "plusMinusOne": (PLUS_MINUS_ONE, -1),
            "ties": (FLAT, -2)}
PAD = 24
NAMES = ("score", "i_end", "j_end", "i0", "j0", "packed")


def _pairs(B: int, n: int, seed: int):
    """B reads of up to n bases in windows of n + 2 PAD, as the read
    aligner's mesh path builds them: related reads with SNPs, a deletion
    and an insertion, and lowercase codes; random reads; reads shorter
    than n (N past their end); an empty read (n_b = 0) and an all-N
    read."""
    rng = np.random.default_rng(seed)
    m = n + 2 * PAD
    wins = rng.integers(0, 4, (B, m)).astype(np.int8)
    reads = np.full((B, n), 4, np.int8)
    n_vec = np.full(B, n, np.int32)
    for b in range(B):
        r = wins[b, PAD:PAD + n].copy()
        kind = b % 8
        if kind == 1:    # a 3 bp deletion
            r = np.concatenate([r[:n // 2], wins[b, PAD + n // 2 + 3:
                                                 PAD + n + 3]])
        elif kind == 2:  # a 3 bp insertion
            r = np.concatenate([r[:n // 2], rng.integers(0, 4, 3),
                                r[n // 2:n - 3]]).astype(np.int8)
        elif kind == 3:  # random
            r = rng.integers(0, 4, n).astype(np.int8)
        elif kind == 4:  # lowercase
            r[rng.integers(0, n, 5)] += 5
        r[rng.integers(0, n, 2)] = rng.integers(0, 4, 2)
        reads[b] = r
    n_vec[5] = n - 11           # shorter reads
    reads[5, n - 11:] = 4
    n_vec[6] = n // 2
    reads[6, n // 2:] = 4
    n_vec[0] = 0                # an empty read
    reads[0] = 4
    reads[7] = 4                # an all-N read of full length
    return reads, wins, n_vec, np.full(B, m, np.int32)


def _jax(reads, wins, n_vec, m_vec, scores, gap):
    B, n = reads.shape
    m = wins.shape[1]
    return [np.asarray(x) for x in jax_wf.local_align_full(
        jnp.asarray(reads), jnp.asarray(wins), jnp.asarray(n_vec[:, None]),
        jnp.asarray(m_vec[:, None]), scores, n=n, m=m, gap=gap,
        interpret=True)]


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_local_align_full_matches_jax(scoring):
    scores, gap = SCORINGS[scoring]
    B, n = 8, 40
    args = _pairs(B, n, seed=len(scoring))
    want = _jax(*args, scores, gap)
    got = port_wf.local_align_full(*(torch.from_numpy(a) for a in args),
                                   scores, gap)
    assert len(got) == 6
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.uint8 if name == "packed" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    score = want[0]
    # the empty and the all-N read: nothing to align, ops all 3
    assert (score[[0, 7]] == 0).all()
    for k in range(1, 5):
        assert (want[k][[0, 7]] == 0).all()
    assert (want[5][[0, 7]] == 0xFF).all()
    if scoring == "humanChimp":
        assert (score[[1, 2, 4, 5, 6]] > 1200).all()
    # shorter reads stop inside their own grid
    assert (want[1] <= args[2]).all()


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_local_walk_on_jax_trace(scoring):
    """The walk's plain version, from the JAX K4's bv, bd and trace (its
    lanes past n + 1 dropped), against the JAX walk."""
    scores, gap = SCORINGS[scoring]
    reads, wins, n_vec, m_vec = _pairs(8, 40, seed=3 + len(scoring))
    B, n = reads.shape
    m = wins.shape[1]
    k4 = jax_wf.wavefront_local(
        jnp.asarray(reads), jnp.asarray(wins), jnp.asarray(n_vec[:, None]),
        jnp.asarray(m_vec[:, None]), scores, n=n, m=m, gap=gap,
        with_trace=True, interpret=True)
    bv, bd, trace = (np.ascontiguousarray(np.asarray(x)[..., :n + 1])
                     for x in k4)
    rows = port_dp.gsw_walk_pack_reference(
        "local", torch.from_numpy(trace), torch.from_numpy(bv),
        torch.from_numpy(bd)).numpy()
    want = _jax(reads, wins, n_vec, m_vec, scores, gap)
    P = -(-(n + m) // 4)
    assert rows.shape == (B, 20 + P)
    meta = np.ascontiguousarray(rows[:, :20]).view("<i4")
    for k in range(5):
        np.testing.assert_array_equal(meta[:, k], want[k], err_msg=NAMES[k])
    np.testing.assert_array_equal(rows[:, 20:], want[5])


def test_local_align_full_long_gap():
    """HUMAN_CHIMP_TWO with gap -600 on longer reads (n = 96), a walk of
    up to D = 240 steps."""
    args = _pairs(8, 96, seed=11)
    want = _jax(*args, HUMAN_CHIMP_TWO, -600)
    got = port_wf.local_align_full(*(torch.from_numpy(a) for a in args),
                                   HUMAN_CHIMP_TWO, -600)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_local_align_full_empty_batch():
    args = [torch.from_numpy(a[:0]) for a in _pairs(8, 40, seed=1)]
    got = port_wf.local_align_full(*args, HUMAN_CHIMP_TWO, -600)
    assert [tuple(g.shape) for g in got] == [(0,)] * 5 + [(0, 32)]
