"""The port's pairwise global alignment (gonomics_tpu_torch/align/) on the
CPU against the JAX package: `affine_gap_batch`, `const_gap_batch`,
`affine_gap` and `const_gap` with `device="cpu"` against the same calls
with `backend="interpret"` (the Pallas kernels in interpret mode) and
against the numpy oracle `gonomics_tpu.align.oracle`. Scores and
(run_length, op) routes must be equal."""

import numpy as np
import pytest
import torch

from gonomics_tpu import align as jax_align
from gonomics_tpu.align import matrices as jax_matrices
from gonomics_tpu.align import oracle
from gonomics_tpu_torch import align as port_align
from gonomics_tpu_torch.align import cigar as port_cigar
from gonomics_tpu_torch.align import matrices as port_matrices
from gonomics_tpu_torch.align.cigar import COL_D, COL_I, COL_M

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
# (scores, affine gap open, affine gap extend, const gap)
SCORINGS = {"humanChimp": (port_align.HUMAN_CHIMP_TWO, -600, -150, -430),
            "default": (port_align.DEFAULT, -400, -30, -200),
            "plusMinusOne": (PLUS_MINUS_ONE, -1, -1, -1)}


def _runs(route):
    return [(c.run_length, c.op) for c in route]


def _consumed(route):
    a = sum(c.run_length for c in route if c.op in (COL_M, COL_D))
    b = sum(c.run_length for c in route if c.op in (COL_M, COL_I))
    return a, b


def _pairs(seed: int, count: int = 6):
    """Related pairs (SNPs, a deletion, an insertion) and random pairs
    with N codes, of lengths 1..59."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        n = int(rng.integers(1, 60))
        a = rng.integers(0, 5 if k % 2 else 4, n).astype(np.int8)
        if k % 2:
            b = rng.integers(0, 5, int(rng.integers(1, 60))).astype(np.int8)
        else:
            b = a.copy()
            b[rng.random(n) < 0.1] = rng.integers(0, 4)
            cut = int(rng.integers(0, n))
            b = np.concatenate([b[:cut], b[cut + 2:],
                                rng.integers(0, 4, 3).astype(np.int8)])
        pairs.append((a, b))
    return pairs


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("mode", ["affine", "const"])
def test_batch_matches_interpret_and_oracle(mode, scoring):
    scores, go, ge, gap = SCORINGS[scoring]
    pairs = _pairs(seed=len(scoring))
    if mode == "affine":
        got = port_align.affine_gap_batch(pairs, scores, go, ge, device="cpu")
        want = jax_align.affine_gap_batch(pairs, scores, go, ge,
                                          backend="interpret")
        ref = [oracle.affine_gap(a, b, scores, go, ge) for a, b in pairs]
    else:
        got = port_align.const_gap_batch(pairs, scores, gap, device="cpu")
        want = jax_align.const_gap_batch(pairs, scores, gap,
                                         backend="interpret")
        ref = [oracle.const_gap(a, b, scores, gap) for a, b in pairs]
    assert len(got) == len(pairs)
    for (gs, gr), (ws, wr), (rs, rr), (a, b) in zip(got, want, ref, pairs):
        assert gs == ws == rs
        assert _runs(gr) == _runs(wr) == _runs(rr)
        assert _consumed(gr) == (len(a), len(b))


@pytest.mark.parametrize("mode", ["affine", "const"])
def test_single_pair_entry_points(mode):
    a = np.array([3, 3, 2, 3, 3, 0, 3, 3, 1], np.int8)   # TTGTTATTC
    b = np.array([3, 3, 2, 3, 3, 1], np.int8)            # TTGTTC
    H = port_align.HUMAN_CHIMP_TWO
    if mode == "affine":
        got = port_align.affine_gap(a, b, H, -600, -150, device="cpu")
        want = jax_align.affine_gap(a, b, H, -600, -150, backend="interpret")
    else:
        got = port_align.const_gap(a, b, H, -430, device="cpu")
        want = jax_align.const_gap(a, b, H, -430, backend="interpret")
    assert got[0] == want[0]
    assert _runs(got[1]) == _runs(want[1])
    if mode == "const":
        assert port_align.view(a, b, got[1]) == "TTGTTATTC\nTTG---TTC\n"


@pytest.mark.parametrize("mode", ["affine", "const"])
def test_score_only_matches_oracle(mode):
    """tests/test_align.py:141-152, against the port (and const too)."""
    rng = np.random.default_rng(9)
    pairs = [(rng.integers(0, 4, 33).astype(np.int8),
              rng.integers(0, 4, 47).astype(np.int8)) for _ in range(3)]
    H = port_align.HUMAN_CHIMP_TWO
    if mode == "affine":
        got = port_align.affine_gap_batch(pairs, H, -600, -150, device="cpu",
                                          with_cigar=False)
        want = [oracle.affine_gap(a, b, H, -600, -150) for a, b in pairs]
    else:
        got = port_align.const_gap_batch(pairs, H, -430, device="cpu",
                                         with_cigar=False)
        want = [oracle.const_gap(a, b, H, -430) for a, b in pairs]
    for (gs, gr), (ws, _) in zip(got, want):
        assert gr is None
        assert gs == ws


def test_affine_score_vs_bruteforce():
    """tests/test_align.py:85-114: a 3-state DP in plain loops as an
    independent oracle, against the port."""
    rng = np.random.default_rng(1)
    D_ = port_align.DEFAULT
    for _ in range(10):
        n, m = rng.integers(1, 14, 2)
        a = rng.integers(0, 5, n)
        b = rng.integers(0, 5, m)
        go_, ge = -400, -30
        NEG = -(2 ** 62)
        M = np.full((n + 1, m + 1), NEG, dtype=object)
        I = np.full((n + 1, m + 1), NEG, dtype=object)
        D = np.full((n + 1, m + 1), NEG, dtype=object)
        M[0][0], I[0][0], D[0][0] = 0, go_, go_
        for j in range(1, m + 1):
            I[0][j] = I[0][j - 1] + ge
        for i in range(1, n + 1):
            D[i][0] = D[i - 1][0] + ge
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                s = int(D_[a[i - 1], b[j - 1]])
                M[i][j] = s + max(M[i - 1][j - 1], I[i - 1][j - 1],
                                  D[i - 1][j - 1])
                I[i][j] = max(go_ + ge + M[i][j - 1], ge + I[i][j - 1],
                              go_ + ge + D[i][j - 1])
                D[i][j] = max(go_ + ge + M[i - 1][j], go_ + ge + I[i - 1][j],
                              ge + D[i - 1][j])
        want = max(M[n][m], I[n][m], D[n][m])
        got, route = port_align.affine_gap(a, b, D_, go_, ge, device="cpu")
        assert got == want
        assert _consumed(route) == (n, m)


@pytest.mark.parametrize("swap", [False, True], ids=["alpha_empty",
                                                      "beta_empty"])
def test_one_empty_side(swap):
    """An empty sequence against ACG: const -200 gives -600 and affine
    -400/-30 gives -490, one run of 3 I (or 3 D when swapped)."""
    pair = (np.zeros(0, np.int8), np.array([0, 1, 2], np.int8))
    if swap:
        pair = pair[::-1]
    op = COL_D if swap else COL_I
    D_ = port_align.DEFAULT
    const = port_align.const_gap_batch([pair], D_, -200, device="cpu")[0]
    affine = port_align.affine_gap_batch([pair], D_, -400, -30,
                                         device="cpu")[0]
    assert (const[0], _runs(const[1])) == (-600, [(3, op)])
    assert (affine[0], _runs(affine[1])) == (-490, [(3, op)])
    jc = jax_align.const_gap_batch([pair], D_, -200, backend="interpret")[0]
    ja = jax_align.affine_gap_batch([pair], D_, -400, -30,
                                    backend="interpret")[0]
    assert (jc[0], _runs(jc[1])) == (const[0], _runs(const[1]))
    assert (ja[0], _runs(ja[1])) == (affine[0], _runs(affine[1]))
    assert oracle.const_gap(*pair, D_, -200)[0] == -600
    assert oracle.affine_gap(*pair, D_, -400, -30)[0] == -490


def test_codes_above_four_raise():
    bad = np.array([0, 5, 1], np.int8)
    ok = np.array([0, 1], np.int8)
    D_ = port_align.DEFAULT
    with pytest.raises(ValueError, match="alpha"):
        port_align.const_gap(bad, ok, D_, -200, device="cpu")
    with pytest.raises(ValueError, match="beta"):
        port_align.affine_gap(ok, bad, D_, -400, -30, device="cpu")


def test_default_device_is_the_card():
    """device=None means the card; without one it raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = np.array([0, 1], np.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_align.const_gap(a, a, port_align.DEFAULT, -200)


def test_matrices_equal_jax():
    assert set(port_matrices.BY_NAME) == set(jax_matrices.BY_NAME)
    for name, want in jax_matrices.BY_NAME.items():
        got = port_matrices.BY_NAME[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
    assert port_matrices.VERY_NEG_INT32 == jax_matrices.VERY_NEG_INT32


def test_cigar_formatting_equals_jax():
    from gonomics_tpu.align import cigar as jax_cigar

    rng = np.random.default_rng(4)
    ops = [int(x) for x in rng.integers(0, 3, 40)]
    got = port_cigar.runs_from_ops(ops)
    want = jax_cigar.runs_from_ops(ops)
    assert [repr(c) for c in got] == [repr(c) for c in want]
    assert port_cigar.go_format(got) == jax_cigar.go_format(want)
    assert port_cigar.print_cigar(got) == jax_cigar.print_cigar(want)
    na = sum(c.run_length for c in got if c.op != COL_I)
    nb = sum(c.run_length for c in got if c.op != COL_D)
    a = rng.integers(0, 5, na).astype(np.int8)
    b = rng.integers(0, 5, nb).astype(np.int8)
    assert port_cigar.view(a, b, got) == jax_cigar.view(a, b, want)
