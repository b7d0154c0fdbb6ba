"""The port's wavefront DP (gonomics_tpu_torch/ops/wavefront.py) against
the JAX package's `wavefront_align`, whose Pallas kernels K2
(`_affine_kernel`) and K3 (`_const_kernel`) run here in interpret mode.

Every value is int32 or int8, so every comparison is exact. The port runs
on CPU tensors here, which takes each kernel's plain PyTorch version; the
CUDA kernels are held against those same plain versions on the card by
tests/test_torch_card.py and by chip_smoke.py.

Compared: every interior trace cell (1 <= i <= n, 1 <= j <= m of the
padded batch), each pair's result at its lane n_b, and the whole result
rows over the port's n+1 lanes. The trace codes of row 0, column 0 and
of lanes outside the grid are not compared: there the Pallas kernel
writes the argmax of its lane shift's junk, which no walk reads.
"""

import jax
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import DEFAULT, HUMAN_CHIMP_TWO
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import wavefront as port_wf

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
# (scores, affine gap open, affine gap extend, const gap)
SCORINGS = {"humanChimp": (HUMAN_CHIMP_TWO, -600, -150, -430),
            "default": (DEFAULT, -400, -30, -200),
            "plusMinusOne": (PLUS_MINUS_ONE, -1, -1, -1)}


def _related(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """A sequence of n bases and a relative of it: SNPs, a deletion, an
    insertion and an N."""
    a = rng.integers(0, 4, n).astype(np.int8)
    b = a.copy()
    b[rng.random(n) < 0.08] = rng.integers(0, 4)
    cut = int(rng.integers(0, max(1, n - 4)))
    b = np.concatenate([b[:cut], b[cut + 3:]])
    ins = int(rng.integers(0, len(b) + 1))
    b = np.concatenate([b[:ins], rng.integers(0, 4, 4).astype(np.int8),
                        b[ins:]])
    b[int(rng.integers(0, len(b)))] = 4
    return a, b


def _batch(kind: str, seed: int):
    """A batch of pairs, padded as `pairwise._pad_batch` pads them.

    mixed: related pairs of mixed lengths up to 60, random pairs and N
    codes. edges: length-1 pairs, one side empty (either side), both
    sides empty, and negative codes (alpha clips them to 0; beta scores
    them as code 1)."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        pairs = [_related(rng, int(rng.integers(20, 57))) for _ in range(4)]
        pairs += [(rng.integers(0, 5, int(rng.integers(1, 60))),
                   rng.integers(0, 5, int(rng.integers(1, 60))))
                  for _ in range(3)]
    else:
        acg = np.array([0, 1, 2], np.int8)
        empty = np.zeros(0, np.int8)
        pairs = [(np.array([3]), np.array([3])), (np.array([1]),
                                                    np.array([4])),
                 (empty, acg), (acg, empty), (empty, empty),
                 (np.array([-3, 0, 2, -1, 3]), np.array([1, -2, 2, 3, -1])),
                 _related(rng, 9)]
    B = len(pairs)
    n = max(len(a) for a, _ in pairs)
    m = max(len(b) for _, b in pairs)
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    for i, (a, b) in enumerate(pairs):
        alpha[i, :len(a)] = a
        beta[i, :len(b)] = b
    nb = np.array([len(a) for a, _ in pairs])
    fin = (nb + np.array([len(b) for _, b in pairs])).astype(np.int32)
    return alpha, beta, fin, nb


def _interior(n: int, m: int, B: int) -> np.ndarray:
    d = np.arange(1, n + m + 1)[:, None, None]
    s = np.arange(n + 1)[None, None, :]
    return np.broadcast_to((s >= 1) & (s <= n) & (d - s >= 1) & (d - s <= m),
                           (n + m, B, n + 1))


@pytest.mark.parametrize("kind", ["mixed", "edges"])
@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("with_trace", [True, False], ids=["trace", "score"])
@pytest.mark.parametrize("mode", ["affine", "const"])
def test_wavefront_align_matches_jax(mode, with_trace, scoring, kind):
    scores, go, ge, gap = SCORINGS[scoring]
    if mode == "const":
        go, ge = gap, 0
    alpha, beta, fin, nb = _batch(kind, seed=len(scoring) + len(kind))
    B, n = alpha.shape
    m = beta.shape[1]
    want = jax_wf.wavefront_align(
        jax.numpy.asarray(alpha), jax.numpy.asarray(beta),
        jax.numpy.asarray(fin[:, None]), scores, n=n, m=m, gap_open=go,
        gap_extend=ge, with_trace=with_trace, mode=mode, interpret=True)
    got = port_wf.wavefront_align(
        torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(fin), scores, gap_open=go, gap_extend=ge,
        with_trace=with_trace, mode=mode)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (1 if not with_trace else
                                     4 if mode == "affine" else 2)
    *res_got, trace_got = got if with_trace else (*got, None)
    *res_want, trace_want = want if with_trace else (*want, None)
    rows = np.arange(B)
    for g, w in zip(res_got, res_want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.int32 and g.shape == (B, n + 1)
        np.testing.assert_array_equal(g[rows, nb], w[rows, nb])
        np.testing.assert_array_equal(g, w[:, :n + 1])
    if with_trace:
        g, w = trace_got.numpy(), np.asarray(trace_want)[:, :, :n + 1]
        assert g.dtype == np.int8 and g.shape == (n + m, B, n + 1)
        mask = _interior(n, m, B)
        np.testing.assert_array_equal(g[mask], w[mask])


def test_unfinished_pair_keeps_neg():
    """A pair whose diagonal fin_b is never reached keeps NEG, as the
    Pallas kernel's capture does."""
    alpha, beta, fin, _ = _batch("edges", seed=3)
    fin[0] = alpha.shape[1] + beta.shape[1] + 5
    res = port_wf.wavefront_align(
        torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(fin), DEFAULT, gap_open=-400, gap_extend=-30,
        with_trace=False, mode="affine")
    assert (res[0] == port_wf.NEG).all()


def test_unknown_mode_raises():
    alpha, beta, fin, _ = _batch("edges", seed=3)
    with pytest.raises(ValueError, match="mode"):
        port_wf.wavefront_align(
            torch.from_numpy(alpha), torch.from_numpy(beta),
            torch.from_numpy(fin), DEFAULT, gap_open=-1, gap_extend=0,
            with_trace=False, mode="local")
