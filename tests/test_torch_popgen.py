"""The port's popgen device functions (gonomics_tpu_torch/popgen.py, on
the CPU) against the JAX package: ``afs_sample_density_grid`` on (n, k,
alpha) triples built here from a numpy seed, and ``wright_fisher_sim``,
which cannot replay ``jax.random`` and is held to the JAX test's
statistical checks.

The grid is float32 in both. Its log-space terms reach lgamma(n + 1)
(863 at n = 200) while the result is of order 10, and the JAX's float32
``gammaln`` is 2-3 ulp from the true value there (3.1e-4 at x = 400;
``torch.lgamma`` 6e-5), so no float32 evaluation that is not the JAX's
own to the bit meets rtol 1e-5 and atol 1e-6 at every triple. The test
holds the port to the JAX within rtol 1e-5 and atol 1e-6 plus 8 float32
ulp of the terms' magnitude, lgamma(n + 1) + |F|, and asserts that the
port is no farther than the JAX from a float64 evaluation of the same
grid.
"""

import math

import numpy as np
import pytest
import torch
from scipy.special import gammaln

from gonomics_tpu import popgen as jpopgen
from gonomics_tpu_torch import popgen

EPS32 = float(np.finfo(np.float32).eps)


def _triples(seed: int, count: int, n_max: int):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, n_max + 1, count)
    k = (rng.random(count) * (n - 1)).astype(np.int64) + 1   # 1 .. n - 1
    alpha = rng.uniform(-20, 20, count)
    alpha[alpha == 0] = 0.5
    n[:4], k[:4], alpha[:4] = [20, 20, 2, 300], [19, 5, 1, 299], \
        [2.0, 2.0, -3.0, 7.5]
    return n, k, alpha


def _grid_f64(n, k, alpha, G: int = 2049):
    """The JAX function's grid, in float64 on the float32 grid points and
    inputs."""
    n, k = n.astype(np.float64), k.astype(np.float64)
    alpha = alpha.astype(np.float32).astype(np.float64)
    p = torch.linspace(1e-9, 1 - 1e-9, G).numpy().astype(np.float64)
    with np.errstate(all="ignore"):
        lb = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
        expr = ((k[:, None] - 1) * np.log(p)[None]
                + (n[:, None] - k[:, None] - 1) * np.log1p(-p)[None])
        sel = np.log((1 - np.exp(-alpha[:, None] * (1 - p[None]))) * 2
                     / (1 - np.exp(-alpha[:, None])))
        lf = lb[:, None] + expr + sel
        w = np.ones(G)
        w[1:-1:2], w[2:-1:2] = 4, 2
        m = lf.max(1, keepdims=True)
        h = (p[-1] - p[0]) / (G - 1)
        return m[:, 0] + np.log((w * np.exp(lf - m)).sum(1) * h / 3)


@pytest.mark.parametrize("n_max,seed", [(10, 0), (60, 1), (300, 2)])
def test_grid_matches_jax(n_max, seed):
    n, k, alpha = _triples(seed, 4096, n_max)
    want = np.asarray(jpopgen.afs_sample_density_grid(n, k, alpha))
    got = popgen.afs_sample_density_grid(n, k, alpha, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4096,)
    got = got.numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert nan[k == n - 1].all()          # the k = n - 1 quirk
    ok = ~nan
    ulps = 8 * EPS32 * (gammaln(n + 1.0) + np.abs(want))
    assert (np.abs(got - want)
            <= 1e-6 + 1e-5 * np.abs(want) + ulps)[ok].all()
    truth = _grid_f64(n, k, alpha)
    assert np.array_equal(np.isnan(truth), nan)
    assert (np.abs(got - truth)[ok].max()
            <= np.abs(want - truth)[ok].max())


def test_grid_nan_where_k_is_n_minus_1():
    """1 - 1e-9 rounds to 1.0 in float32: log1p(-1) = -inf, times
    n - k - 1 = 0, is NaN, in the JAX and the port alike."""
    got = popgen.afs_sample_density_grid([20, 20], [19, 18], [2.0, 2.0],
                                         device="cpu").numpy()
    want = np.asarray(jpopgen.afs_sample_density_grid([20, 20], [19, 18],
                                                      [2.0, 2.0]))
    assert np.isnan(got[0]) and np.isnan(want[0])
    assert np.isfinite(got[1]) and abs(got[1] - want[1]) < 1e-4


def test_grid_matches_adaptive_integral():
    """As test_popgen.py:29: within 1e-3 of the JAX's adaptive Simpson
    afs_sample_density at (20, 5, 2.0)."""
    cache = jpopgen.build_binom_cache([20])
    want = jpopgen.afs_sample_density(20, 5, 2.0, cache, 1e-8)
    got = float(popgen.afs_sample_density_grid([20], [5], [2.0],
                                               device="cpu")[0])
    assert abs(got - want) < 1e-3


def test_wright_fisher_shape_and_seed():
    a = popgen.wright_fisher_sim(500, 64, s=0.01, init_freq=0.3, seed=11,
                                 device="cpu")
    b = popgen.wright_fisher_sim(500, 64, s=0.01, init_freq=0.3, seed=11,
                                 device="cpu")
    c = popgen.wright_fisher_sim(500, 64, s=0.01, init_freq=0.3, seed=12,
                                 device="cpu")
    assert a.shape == (64,) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    counts = a.numpy().astype(np.float64) * 500
    assert np.allclose(counts, np.round(counts), rtol=0, atol=1e-3)
    assert ((a >= 0) & (a <= 1)).all()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_wright_fisher_drift(seed):
    """test_popgen.py:36's check: positive selection drives the allele up
    (1000, 200, s = 0.05, init 0.1)."""
    traj = popgen.wright_fisher_sim(1000, 200, s=0.05, init_freq=0.1,
                                    seed=seed, device="cpu").numpy()
    assert traj.shape == (200,)
    assert traj[-1] > 0.5


def test_wright_fisher_neutral_mean():
    """Without selection the frequency is a martingale: the mean final
    frequency over 200 seeds lies within 4 standard errors of init_freq."""
    init = 0.3
    finals = np.array([float(popgen.wright_fisher_sim(
        200, 40, s=0.0, init_freq=init, seed=s, device="cpu")[-1])
        for s in range(200)])
    se = finals.std(ddof=1) / math.sqrt(len(finals))
    assert se > 0 and abs(finals.mean() - init) <= 4 * se
