"""The port's row-blocked score-mode affine wavefront
(gonomics_tpu_torch/ops/wavefront.py `wavefront_align_blocked`) against the
JAX package's `wavefront_align_blocked`, whose Pallas kernel K9
(`_affine_block_kernel`) runs here in interpret mode once a row block, and
each pair's score against the numpy oracle `align.oracle.affine_gap`.

Every lane 0..r_rows of every block is compared exactly; the JAX result's
lanes above r_rows (its 128-lane quantum), which the port leaves out, are
checked to be NEG. The port runs on the CPU here, which takes the plain
version `affine_block_reference`; the CUDA kernel `affine_block` is held
against it on the card by tests/test_torch_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align import oracle
from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch import NEG
from gonomics_tpu_torch.ops import wavefront as port_wf

GAPS = dict(gap_open=-600, gap_extend=-150)


def _batch(B: int, n: int, m: int, seed: int, codes: str = "dna"):
    """B pairs padded to (n, m) with code 4; pair b has its own n_b <= n
    and m_b <= m (pair 0 the full widths). dna: codes 0..4; wide: alpha
    -1..6 and beta -1..5 (clipped, and scored by `_select_score`)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(1, n + 1, B)
    mb = rng.integers(1, m + 1, B)
    nb[0], mb[0] = n, m
    lo, hi = (0, 5) if codes == "dna" else (-1, 7)
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    for b in range(B):
        alpha[b, :nb[b]] = rng.integers(lo, hi, nb[b])
        beta[b, :mb[b]] = rng.integers(lo, min(hi, 6), mb[b])
    return alpha, beta, (nb + mb).astype(np.int32), nb, mb


# (B, n, m, r_rows): r_rows not dividing n (three shapes, alpha shorter
# than beta among them, r_rows = 5 in one), n a multiple of r_rows, one
# block (n < r_rows), and out-of-range codes with prof16
@pytest.mark.parametrize("B,n,m,r_rows,codes,prof16", [
    (3, 19, 23, 8, "dna", False), (2, 16, 11, 8, "dna", False),
    (2, 7, 30, 8, "dna", False), (2, 25, 25, 5, "dna", False),
    (2, 24, 13, 8, "dna", False), (2, 6, 15, 8, "dna", False),
    (3, 13, 17, 6, "wide", True)])
def test_blocked_matches_jax(B, n, m, r_rows, codes, prof16):
    alpha, beta, fin, nb, mb = _batch(B, n, m, seed=n + m, codes=codes)
    kw = dict(n=n, m=m, r_rows=r_rows, prof16=prof16, **GAPS)
    want = np.asarray(jax_wf.wavefront_align_blocked(
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(fin[:, None]),
        HUMAN_CHIMP_TWO, interpret=True, **kw))
    got = port_wf.wavefront_align_blocked(alpha, beta, fin, HUMAN_CHIMP_TWO,
                                          device="cpu", **kw)
    blocks = -(-n // r_rows)
    assert got.dtype == torch.int32
    assert got.shape == (blocks, B, r_rows + 1)
    np.testing.assert_array_equal(got.numpy(), want[:, :, :r_rows + 1])
    assert (want[:, :, r_rows + 1:] == NEG).all()
    if codes == "dna":
        for b in range(B):
            k = (nb[b] - 1) // r_rows
            score, _ = oracle.affine_gap(alpha[b, :nb[b]], beta[b, :mb[b]],
                                         HUMAN_CHIMP_TWO, -600, -150)
            assert got[k, b, nb[b] - k * r_rows] == score, b


def test_blocked_tensors_stay_where_they_lie():
    """CPU tensors take the plain version, fin as (B, 1) or (B,), and no
    kernel launch is counted; the plain version equals K2's score mode at
    each pair's score lane."""
    alpha, beta, fin, nb, _ = _batch(4, 30, 21, seed=8)
    a, b = torch.from_numpy(alpha), torch.from_numpy(beta)
    before = port_wf.affine_block_launches
    got = port_wf.wavefront_align_blocked(
        a, b, torch.from_numpy(fin[:, None]), HUMAN_CHIMP_TWO, n=30, m=21,
        r_rows=7, **GAPS)
    assert port_wf.affine_block_launches == before
    assert torch.equal(got, port_wf.wavefront_align_blocked(
        a, b, torch.from_numpy(fin), HUMAN_CHIMP_TWO, n=30, m=21, r_rows=7,
        **GAPS))
    k2 = port_wf.wavefront_align(a, b, torch.from_numpy(fin), HUMAN_CHIMP_TWO,
                                 with_trace=False, **GAPS)
    for i in range(4):
        k = (nb[i] - 1) // 7
        assert got[k, i, nb[i] - 7 * k] == k2[i, nb[i]]
