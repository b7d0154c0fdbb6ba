"""The port's lowmem aligner (gonomics_tpu_torch/ops/wavefront.py
`affine_gap_lowmem_batch`) on a pair wide enough that its backward window
moves: n >= 900 and K = 8 give W = 768 < S = n + 1, so the window start is
non-zero in some blocks and clipped at S - W in others. The JAX package's
windows differ there (its lanes are S8 = round_up(n + 1, 1024)), and the
results must be equal all the same: within a block the walk stays at lanes
>= i - K, and a cell on step t depends only on entry lanes >= its lane - t,
which lie inside any window that starts at or below i - 2K.

Its own file because the JAX forward of 120 blocks takes ~30 s to compile
in interpret mode, and the test run spreads files over its workers.
"""

import numpy as np

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import wavefront as port_wf


def test_window_start_moves_and_clips(monkeypatch):
    """Records each block's i and window start, asserts that some window
    start was non-zero without the clip and that the clip at S - W bound
    in another block, and holds (score, ops, i0, j0) to the JAX's."""
    B, n, m, K = 2, 900, 60, 8
    rng = np.random.default_rng(5)
    alpha = rng.integers(0, 4, (B, n)).astype(np.int8)
    beta = rng.integers(0, 4, (B, m)).astype(np.int8)
    beta[0] = alpha[0, 300:300 + m]
    seen = []
    window = port_wf.affine_bwd_window

    def record(alpha_, beta_, state, d0, i, *args):
        trace, wlo = window(alpha_, beta_, state, d0, i, *args)
        seen.append((i.clone(), wlo.clone()))
        return trace, wlo

    monkeypatch.setattr(port_wf, "affine_bwd_window", record)
    got = port_wf.affine_gap_lowmem_batch(alpha, beta, HUMAN_CHIMP_TWO, -600,
                                          -150, checkersize=K, device="cpu")
    W = port_wf.window_width(n, K)
    S = n + 1
    unclipped = [((i.long() - 2 * K - 128) // 128 * 128) for i, _ in seen]
    assert any(bool(((w > 0) & (u == w)).any())
               for u, (_, w) in zip(unclipped, seen))
    assert any(bool(((u > S - W) & (w == S - W)).any())
               for u, (_, w) in zip(unclipped, seen))
    want = jax_wf.affine_gap_lowmem_batch(alpha, beta, HUMAN_CHIMP_TWO, -600,
                                          -150, checkersize=K,
                                          interpret=True)
    for (gs, gops, gi, gj), (ws, wops, wi, wj) in zip(got, want):
        assert (gs, gi, gj) == (ws, wi, wj)
        assert gops.dtype == np.int8
        np.testing.assert_array_equal(gops, wops)

