"""Distribution fitting, a copy of ``gonomics_tpu/numbers/fit.py``
(294 lines, whole), gonomics' ``numbers/fit``.

The zero-truncated negative binomial coordinate-ascent fit (ztnb.go),
used by strawToBedpe's HiC contact-score null models: the 8-direction
ascent and its check ordering replicate gonomics exactly, so fitted
(R, P) land on the identical grid points. ``run_mixture_model_1d`` is
the 1-D Gaussian mixture EM (mixtureModel.go); with ``rng=None`` it
draws from this package's ``gorand.default()``.
"""

from __future__ import annotations

import math

from . import logspace
from .distributions import negative_binomial_log_dist

# directions (ztnb.go:14-24)
(NEUTRAL, NORTH, NORTHEAST, EAST, SOUTHEAST, SOUTH, SOUTHWEST, WEST,
 NORTHWEST) = range(9)


class _ZtnbLikelihood:
    """Memoized ZTNB log-likelihood over histogram data
    (zeroTruncatedNegativeBinomialLogLikelihood, ztnb.go:52). Zero-count
    bins contribute exactly +0.0 in the reference's sequential sum, so
    only nonzero bins are accumulated (in the same increasing-i order)."""

    def __init__(self, data: list[int]):
        self.nonzero = [(i, float(c)) for i, c in enumerate(data)
                        if i >= 1 and c != 0]
        self.cache: dict[tuple[float, float], float] = {}

    def __call__(self, r: float, p: float) -> float:
        key = (r, p)
        got = self.cache.get(key)
        if got is not None:
            return got
        log_trunc = math.log(1 - math.pow(p, r))
        ll = 0.0
        for i, count in self.nonzero:
            density = negative_binomial_log_dist(i, r, p)
            ll += count * logspace.divide(density, log_trunc)
        self.cache[key] = ll
        return ll


def _check(ll, r, p, r_step, p_step, direction, cur_dir, cur_like):
    """check{North,...} helpers (ztnb.go:66-160): propose one step."""
    if direction == NORTH:
        nr, np_ = r + r_step, p
    elif direction == NORTHEAST:
        if p + p_step > 0.999:
            return cur_dir, cur_like
        nr, np_ = r + r_step, p + p_step
    elif direction == EAST:
        if p + p_step > 0.999:
            return cur_dir, cur_like
        nr, np_ = r, p + p_step
    elif direction == SOUTHEAST:
        if p + p_step > 0.999 or r - r_step < 0.001:
            return cur_dir, cur_like
        nr, np_ = r - r_step, p + p_step
    elif direction == SOUTH:
        if r - r_step < 0.001:
            return cur_dir, cur_like
        nr, np_ = r - r_step, p
    elif direction == SOUTHWEST:
        if r - r_step < 0.001 or p - p_step < 0.001:
            return cur_dir, cur_like
        nr, np_ = r - r_step, p - p_step
    elif direction == WEST:
        if p - p_step < 0.001:
            return cur_dir, cur_like
        nr, np_ = r, p - p_step
    else:  # NORTHWEST
        if p - p_step < 0.001:
            return cur_dir, cur_like
        nr, np_ = r + r_step, p - p_step
    next_like = ll(nr, np_)
    if next_like > cur_like:
        return direction, next_like
    return cur_dir, cur_like


# per-heading neighborhood scan order (nextDirection, ztnb.go:166-224)
_SCAN = {
    NORTH: [WEST, NORTHWEST, NORTH, NORTHEAST, EAST],
    NORTHWEST: [SOUTHWEST, WEST, NORTHWEST, NORTH, NORTHEAST],
    WEST: [SOUTH, SOUTHWEST, WEST, NORTHWEST, NORTH],
    SOUTHWEST: [SOUTHEAST, SOUTH, SOUTHWEST, WEST, NORTHWEST],
    SOUTH: [EAST, SOUTHEAST, SOUTH, SOUTHWEST, WEST],
    SOUTHEAST: [NORTHEAST, EAST, SOUTHEAST, SOUTH, SOUTHWEST],
    EAST: [NORTH, NORTHEAST, EAST, SOUTHEAST, SOUTH],
    NORTHEAST: [NORTHWEST, NORTH, NORTHEAST, EAST, SOUTHEAST],
}


def _next_direction(ll, r, p, r_step, p_step, cur_dir, cur_like):
    prev = cur_like
    if cur_dir == NEUTRAL:
        return NEUTRAL, cur_like
    for d in _SCAN[cur_dir]:
        cur_dir, cur_like = _check(ll, r, p, r_step, p_step, d,
                                   cur_dir, cur_like)
    if cur_like == prev:
        return NEUTRAL, cur_like
    return cur_dir, cur_like


def _first_direction(ll, r, p, r_step, p_step):
    cur_dir = NEUTRAL
    cur_like = ll(r, p)
    for d in (NORTH, NORTHEAST, EAST, SOUTHEAST, SOUTH, SOUTHWEST, WEST,
              NORTHWEST):
        cur_dir, cur_like = _check(ll, r, p, r_step, p_step, d,
                                   cur_dir, cur_like)
    return cur_dir, cur_like


def _move(r, p, r_step, p_step, d):
    """moveInDirection (ztnb.go:243-291)."""
    if d == NEUTRAL:
        return r, p
    if d == NORTH:
        return r + r_step, p
    if d == NORTHEAST:
        return (r + r_step, p + p_step) if p + p_step < 0.999 \
            else (r + r_step, p)
    if d == EAST:
        if p + p_step <= 1:
            return r, p + p_step
        raise ArithmeticError("collision with parameter space barrier")
    if d == SOUTHEAST:
        if r - r_step < 0.001 and p + p_step > 0.999:
            raise ArithmeticError("collision with parameter space barrier")
        if r - r_step < 0.001:
            return r, p + p_step
        if p + p_step > 0.999:
            return r - r_step, p
        return r - r_step, p + p_step
    if d == SOUTH:
        if r - r_step < 0.001:
            raise ArithmeticError("collision with parameter space barrier")
        return r - r_step, p
    if d == SOUTHWEST:
        if r - r_step < 0.001 and p - p_step < 0.001:
            raise ArithmeticError("collision with parameter space barrier")
        if r - r_step < 0.001:
            return r, p - p_step
        return r - r_step, p - p_step
    if d == WEST:
        if p - p_step <= 0:
            raise ArithmeticError("collision with parameter space barrier")
        return r, p - p_step
    # NORTHWEST
    if p - p_step <= 0:
        return r + r_step, p
    return r + r_step, p - p_step


class MixtureModel:
    """fit.MixtureModel (mixtureModel.go:11): 1-D Gaussian mixture fit by
    EM. Results live in means/stdev/weights/log_likelihood."""

    def __init__(self):
        self.data = None
        self.k = 0
        self.means = []
        self.stdev = []
        self.weights = []
        self.max_iter = 0
        self.log_likelihood = 0.0


def _sample_without_replacement(data, k: int, rng):
    """sampleWithoutReplacement (mixtureModel.go:253): Fisher-Yates
    shuffle + RandIntInRange draws on the (Go-emulated) global rand."""
    if k > len(data):
        raise ValueError("requested more gaussians than data points")

    def swap(i, j):
        data[i], data[j] = data[j], data[i]

    rng.shuffle(len(data), swap)
    ans = []
    mx = len(data)
    for _ in range(k):
        idx = int(rng.float64() * mx)
        ans.append(data[idx])
        data[idx], data[len(data) - 1] = data[len(data) - 1], data[idx]
        mx -= 1
    return ans


def run_mixture_model_1d(data, k: int, max_iterations: int,
                         max_resets: int, log_prob_epsilon: float,
                         mm: MixtureModel, rng=None):
    """fit.RunMixtureModel1D (mixtureModel.go:40): EM with resets on
    degenerate components; returns (converged, iterations_run).
    Numerics follow the mixtools normpost.c stabilization exactly."""
    import numpy as np

    from .gorand import default

    if rng is None:
        rng = default()
    if len(data) == 0:
        return False, 0
    data = list(data)
    eps = log_prob_epsilon if log_prob_epsilon != 0 else 1e-08

    def init():
        mm.data = data
        mm.k = k
        mm.max_iter = max_iterations
        mm.log_likelihood = math.inf
        mm.means = _sample_without_replacement(data, k, rng)
        mm.stdev = [1.0] * k
        mm.weights = [1.0 / k] * k

    init()
    arr = np.asarray(data, np.float64)
    n = len(arr)
    resets = 0
    converged = False
    iterations = 0
    posteriors = residuals = None
    while resets < max_resets and not converged:
        # E step (expectation, mixtureModel.go:175)
        prev = mm.log_likelihood
        means = np.asarray(mm.means)
        stdev = np.asarray(mm.stdev)
        weights = np.asarray(mm.weights)
        lam_sig = weights / stdev
        res = (arr[None, :] - means[:, None]) ** 2          # (k, n)
        work = res / (2 * stdev * stdev)[:, None]
        minj = np.argmin(work, axis=0)
        mn = work[minj, np.arange(n)]
        w = (lam_sig[:, None] / lam_sig[minj][None, :]) * \
            np.exp(mn[None, :] - work)
        w[minj, np.arange(n)] = 1.0
        rowsum = w.sum(axis=0)
        posteriors = w / rowsum
        mm.log_likelihood = float(
            -(n // 2) * 0.91893853320467274178
            + np.sum(np.log(rowsum) - mn + np.log(lam_sig[minj])))
        residuals = res
        if abs(mm.log_likelihood - prev) < eps:
            converged = True

        # M step (maximization, mixtureModel.go:225)
        psum = posteriors.sum(axis=1)
        mm.weights = list(psum / n)
        mu = posteriors @ arr
        with np.errstate(invalid="ignore"):
            new_means = np.where(psum > 0, mu / np.where(psum > 0, psum,
                                                         1.0), means)
            var = (posteriors * residuals).sum(axis=1)
            var = np.where(psum > 0, var / np.where(psum > 0, psum, 1.0),
                           var)
        mm.means = list(new_means)
        mm.stdev = list(np.sqrt(var))

        degenerate = any(s < 1e-04 for s in mm.stdev) or \
            any(wt < 1e-02 for wt in mm.weights)
        if degenerate:
            resets += 1
            init()
            iterations = 0
            converged = False
            continue
        iterations += 1
        if iterations == mm.max_iter:
            resets += 1
            init()
            iterations = 0
            converged = False
    return converged, iterations


def zero_truncated_negative_binomial(data: list[int], r: float, p: float,
                                     r_step: float, p_step: float):
    """fit.ZeroTruncatedNegativeBinomial (ztnb.go:297): maximum-likelihood
    ZTNB fit to histogram counts via 8-direction coordinate ascent."""
    if r <= 0:
        raise ValueError(f"initial R must be > 0, found {r}")
    if p <= 0 or p >= 1:
        raise ValueError(f"initial P must be a valid probability: {p}")
    ll = _ZtnbLikelihood(data)
    cur_dir, cur_like = _first_direction(ll, r, p, r_step, p_step)
    while cur_dir != NEUTRAL:
        r, p = _move(r, p, r_step, p_step, cur_dir)
        cur_dir, cur_like = _next_direction(ll, r, p, r_step, p_step,
                                            cur_dir, cur_like)
    return r, p
