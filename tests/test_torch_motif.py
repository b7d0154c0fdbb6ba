"""The port's motif scan (gonomics_tpu_torch/motif.py
``scan_scores_device``, on the CPU) against the JAX ``scan_scores_jax``
on sequences built here from a numpy seed that hold every code 0-10 (A,
C, G, T, N, lowercase and gap): the same -inf windows; scores within
rtol 1e-5 plus the float32 rounding of the JAX's sum; exactly equal on a
matrix whose sums are exact in float32. ``read_jaspar`` against the
JAX's on a file the JAX writes.
"""

import numpy as np
import pytest

from gonomics_tpu import motif as jmotif
from gonomics_tpu_torch import motif

EPS32 = float(np.finfo(np.float32).eps)


def _sequence(rng, n: int) -> np.ndarray:
    """Mostly ACGT, with N runs, lowercase stretches, gaps, and every code
    0-10 at least once."""
    seq = rng.integers(0, 4, n).astype(np.int8)
    for _ in range(n // 2000 + 1):
        s = int(rng.integers(0, max(1, n - 50)))
        seq[s:s + int(rng.integers(1, 40))] = 4
        s = int(rng.integers(0, max(1, n - 200)))
        part = seq[s:s + 150]
        part[part <= 4] += 5
    seq[rng.random(n) < 0.002] = 10
    seq[rng.random(n) < 0.001] = rng.integers(0, 11)
    seq[rng.choice(n, 11, replace=False)] = np.arange(11)
    return seq


def _pwm(rng, L: int):
    pfm = jmotif.PositionMatrix("M1", "m", jmotif.FREQUENCY,
                                rng.integers(0, 100, (4, L)).astype(float))
    return jmotif.ppm_to_pwm(jmotif.pfm_to_ppm(pfm, 0.1), 0.41)


@pytest.mark.parametrize("L,n,seed", [(20, 50_000, 0), (6, 20_000, 1),
                                      (13, 7_777, 2), (1, 500, 3),
                                      (25, 30, 4)])
def test_scan_matches_jax(L, n, seed):
    """The same -inf windows; each score within rtol 1e-5 and, where the
    window's sum nearly cancels, the float32 rounding of an L-term sum,
    L eps32 sum_j max_c |w[c, j]|; the port's score the float32 nearest
    the exact sum of the float32 weights (within half an ulp)."""
    rng = np.random.default_rng(seed)
    pwm = _pwm(rng, L)
    seq = _sequence(rng, n)
    assert set(np.unique(seq).tolist()) == set(range(11))
    want = np.asarray(jmotif.scan_scores_jax(pwm, seq))
    got = motif.scan_scores_device(motif.PositionMatrix(mat=pwm.mat), seq,
                                   device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (n - L + 1,)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert (got[~fin] == -np.inf).all() and (fin.mean() > 0.5 or n < 100)
    w32 = pwm.mat.astype(np.float32)
    atol = L * EPS32 * float(np.abs(w32).max(axis=0).sum())
    assert np.allclose(got[fin], want[fin], rtol=1e-5, atol=atol)
    exact = jmotif.scan_scores(jmotif.PositionMatrix(
        mat=w32.astype(np.float64)), seq)[fin]
    assert (np.abs(got[fin] - exact)
            <= np.spacing(np.abs(got[fin])) / 2 + 1e-30).all()


def test_scan_exact_on_dyadic_matrix():
    """A matrix of multiples of 1/8 sums exactly in float32 in any order:
    the port's scores equal the JAX's bit for bit."""
    rng = np.random.default_rng(9)
    mat = rng.integers(-40, 40, (4, 17)) / 8.0
    seq = _sequence(rng, 40_000)
    want = np.asarray(jmotif.scan_scores_jax(
        jmotif.PositionMatrix(mat=mat), seq))
    got = motif.scan_scores_device(motif.PositionMatrix(mat=mat), seq,
                                   device="cpu").numpy()
    assert np.array_equal(got, want)


def test_scan_short_sequence_and_tensor_input():
    import torch

    pm = motif.PositionMatrix(mat=np.ones((4, 5)))
    assert motif.scan_scores_device(pm, np.zeros(4, np.int8),
                                    device="cpu").shape == (0,)
    seq = torch.tensor([0, 1, 2, 3, 0, 4, 1], dtype=torch.int8)
    got = motif.scan_scores_device(pm, seq, device="cpu")
    assert got.tolist() == [5.0, -np.inf, -np.inf]


def test_read_jaspar_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    recs = [jmotif.PositionMatrix(f"MA{i}", f"tf{i}", jmotif.FREQUENCY,
                                  rng.integers(0, 90, (4, 6 + i)) * 1.0)
            for i in range(3)]
    path = str(tmp_path / "m.jaspar")
    jmotif.write_jaspar(path, recs)
    want = jmotif.read_jaspar(path, jmotif.FREQUENCY)
    got = motif.read_jaspar(path, motif.FREQUENCY)
    assert [(m.id, m.name, m.type) for m in got] == [
        (m.id, m.name, m.type) for m in want]
    for g, w in zip(got, want):
        assert g.mat.dtype == np.float64 and np.array_equal(g.mat, w.mat)
