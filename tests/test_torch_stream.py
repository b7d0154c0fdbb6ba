"""The port's streamed score-only affine alignment
(gonomics_tpu_torch/ops/wavefront.py `wavefront_affine_stream`) against
the JAX package's `wavefront_affine_stream`, whose Pallas kernel K8
(`_affine_stream_kernel`) runs here in interpret mode, manual DMA and
semaphores included, and against the numpy oracle `align.oracle.affine_gap`.

Scores are int32, so every comparison is exact. The port runs on the CPU
here, which takes the plain version `affine_stream_reference`; the CUDA
kernel `affine_stream` is held against it on the card by
tests/test_torch_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align import oracle
from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import wavefront as port_wf

GAPS = dict(gap_open=-600, gap_extend=-150)


def _pairs(P: int, B: int, n: int, m: int, codes: str, seed: int):
    """dna: alpha 0..3 and beta 0..4 (N), as tests/test_stream_kernel.py
    draws them. wide: alpha 0..6 (clipped to 4) and beta -1..5 (a
    negative code scores as 1, 5 as N: `_select_score`)."""
    rng = np.random.default_rng(seed)
    lo_a, hi_a, lo_b, hi_b = (0, 4, 0, 5) if codes == "dna" else (0, 7, -1, 6)
    return (rng.integers(lo_a, hi_a, (P, B, n)).astype(np.int8),
            rng.integers(lo_b, hi_b, (P, B, m)).astype(np.int8))


# the shapes of tests/test_stream_kernel.py (square, and m even with
# m > n: the JAX function's odd m_pad column) and one cell
@pytest.mark.parametrize("codes", ["dna", "wide"])
@pytest.mark.parametrize("P,B,n,m,seed", [(4, 2, 17, 17, 1), (2, 2, 9, 14, 2),
                                          (2, 1, 1, 1, 3)])
def test_stream_matches_jax(P, B, n, m, seed, codes):
    alpha, beta = _pairs(P, B, n, m, codes, seed)
    want = np.asarray(jax_wf.wavefront_affine_stream(
        jnp.asarray(alpha), jnp.asarray(beta), HUMAN_CHIMP_TWO, n=n, m=m,
        interpret=True, **GAPS))
    got = port_wf.wavefront_affine_stream(alpha, beta, HUMAN_CHIMP_TWO, n=n,
                                          m=m, device="cpu", **GAPS)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if codes == "dna":
        for p in range(P):
            for b in range(B):
                score, _ = oracle.affine_gap(alpha[p, b], beta[p, b],
                                             HUMAN_CHIMP_TWO, -600, -150)
                assert got[p, b] == score, (p, b)


def test_stream_tensors_stay_where_they_lie():
    """CPU tensors take the plain version whatever `device` says, and no
    kernel launch is counted."""
    alpha, beta = (torch.from_numpy(x) for x in _pairs(2, 3, 12, 20, "dna",
                                                        seed=4))
    before = port_wf.affine_stream_launches
    got = port_wf.wavefront_affine_stream(alpha, beta, HUMAN_CHIMP_TWO, n=12,
                                          m=20, **GAPS)
    assert port_wf.affine_stream_launches == before
    want = port_wf.affine_stream_reference(alpha, beta,
                                           torch.as_tensor(HUMAN_CHIMP_TWO),
                                           -600, -150)
    assert torch.equal(got, want)


@pytest.mark.parametrize("P,n,m", [(3, 4, 4), (2, 6, 4)],
                         ids=["odd_P", "m_below_n"])
def test_stream_rejects_bad_shapes(P, n, m):
    """Odd P and m < n raise ValueError, as the JAX function does (the
    cases of tests/test_stream_kernel.py)."""
    alpha = np.zeros((P, 1, n), np.int8)
    beta = np.zeros((P, 1, m), np.int8)
    with pytest.raises(ValueError):
        jax_wf.wavefront_affine_stream(jnp.asarray(alpha), jnp.asarray(beta),
                                       HUMAN_CHIMP_TWO, n=n, m=m,
                                       interpret=True, **GAPS)
    with pytest.raises(ValueError):
        port_wf.wavefront_affine_stream(alpha, beta, HUMAN_CHIMP_TWO, n=n,
                                        m=m, device="cpu", **GAPS)


# what affine_stream's library reports it is built for (affine_stream_built),
# written here so that the plan is checked without a card
_STREAM_BUILT = {"warps_per_block": 4, "rows_per_lane": (2, 4, 8)}


@pytest.mark.parametrize("n,m,R", [
    (1024, 1024, 8), (0, 5, 2), (1, 1, 2), (64, 64, 2), (65, 70, 4),
    (128, 4096, 4), (129, 300, 8), (100, 100, 4), (200, 300, 8),
    (257, 300, 8), (513, 1023, 8)])
def test_stream_plan(n, m, R):
    """stream_plan by shape alone: the smallest built R whose strip of 32 R
    rows holds all n rows where that is below the main plan's R (8), else
    the main plan's; its strips, and the steps of one (m + 32 R - 1),
    follow."""
    assert port_wf.STREAM_ROWS_PER_LANE == 8
    plan = port_wf.stream_plan(n, m, _STREAM_BUILT)
    assert plan == {"rows_per_lane": R, "strip_rows": 32 * R,
                    "strips": -(-n // (32 * R)),
                    "steps_a_strip": m + 32 * R - 1}


def test_stream_plan_needs_a_built_main():
    with pytest.raises(ValueError, match="not built for 8 rows"):
        port_wf.stream_plan(1024, 1024, {"warps_per_block": 4,
                                         "rows_per_lane": (2, 4)})
