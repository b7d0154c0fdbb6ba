"""Probability distributions, a copy of
``gonomics_tpu/numbers/distributions.py`` (314 lines, whole), gonomics'
``numbers/distribution.go`` and ``logDistribution.go``: densities, the
incomplete beta, Romberg integrals, tail sums and the rejection sampler,
the same float64 steps in the same order.

``_go_gamma``, ``_go_log`` and ``_go_exp`` keep Go's overflow results
(+Inf, -Inf, NaN) where Python's math raises, so that
``regularized_incomplete_beta`` turns Inf/Inf into NaN as Go does.
``poisson_sum`` keeps gonomics' always-empty range and ``binomial_sum``
its double-counted left term.
"""

from __future__ import annotations

import math

from . import binom_coefficient_log
from . import logspace


def normal_dist(x: float, mu: float, sigma: float) -> float:
    return (1.0 / (sigma * math.sqrt(2 * math.pi))) * \
        math.exp(-0.5 * ((x - mu) / sigma) ** 2)


def standard_normal_dist(x: float) -> float:
    return normal_dist(x, 0, 1)


def binomial_dist(n: int, k: int, p: float) -> float:
    return math.exp(binom_coefficient_log(n, k)
                    + k * logspace.go_log(p)
                    + (n - k) * logspace.go_log(1 - p)) \
        if 0 < p < 1 else (1.0 if (p == 0 and k == 0)
                           or (p == 1 and k == n) else 0.0)


def negative_binomial_dist(k: int, r: float, p: float) -> float:
    """P(X == k) failures before the r-th success."""
    coeff = math.lgamma(k + r) - math.lgamma(k + 1) - math.lgamma(r)
    return math.exp(coeff + r * math.log(p) + k * math.log(1 - p))


def geometric_dist(k: int, p: float) -> float:
    return (1 - p) ** k * p


def exp_dist(x: float) -> float:
    return math.exp(-x)


def poisson_dist(k: int, lam: float) -> float:
    if k < 0:
        raise ValueError("poisson undefined for k < 0")
    return math.exp(k * math.log(lam) - lam - math.lgamma(k + 1))


def beta_func(x: float, y: float) -> float:
    return math.exp(math.lgamma(x) + math.lgamma(y) - math.lgamma(x + y))


def beta_dist(x: float, alpha: float, beta: float) -> float:
    if not 0 <= x <= 1:
        raise ValueError("beta dist domain is [0,1]")
    return x ** (alpha - 1) * (1 - x) ** (beta - 1) / beta_func(alpha, beta)


def gamma_dist(x: float, alpha: float, beta: float) -> float:
    if x < 0:
        raise ValueError("gamma dist domain is x >= 0")
    return (beta ** alpha) * (x ** (alpha - 1)) * math.exp(-beta * x) \
        / math.exp(math.lgamma(alpha))


def negative_binomial_log_dist(k: int, r: float, p: float) -> float:
    """numbers.NegativeBinomialDist with logOutput=true
    (distribution.go:39): log P(X == k) with successes r, success prob p."""
    coeff = logspace.divide(math.lgamma(k + r),
                            logspace.multiply(math.lgamma(k + 1),
                                              math.lgamma(r)))
    f = logspace.pow_(math.log(1.0 - p), float(k))
    s = logspace.pow_(math.log(p), r)
    return logspace.multiply(coeff, logspace.multiply(f, s))


# incomplete beta machinery (reference: numbers/incompleteBeta.go,
# constants from randBeta.go:16-18)
REL_ERROR = 1.0e-8
SMALL = 1.0e-30
MAX_ITERATIONS = 200


def _go_gamma(x: float) -> float:
    """Go math.Gamma: +Inf on overflow instead of raising."""
    try:
        return math.gamma(x)
    except OverflowError:
        return math.inf


def _go_log(x: float) -> float:
    return math.nan if math.isnan(x) else \
        (math.log(x) if x > 0 else
         (-math.inf if x == 0 else math.nan))


def _go_exp(x: float) -> float:
    if math.isnan(x):
        return math.nan
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


def regularized_incomplete_beta(a: float, b: float, x: float) -> float:
    """numbers.RegularizedIncompleteBeta (incompleteBeta.go:16):
    Lentz continued-fraction evaluation."""
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - regularized_incomplete_beta(b, a, 1.0 - x)
    # Go math.Gamma overflows to +Inf (BetaFunc, distribution.go:101);
    # Inf/Inf -> NaN propagates through log/exp exactly as the reference.
    log_beta = _go_log(_go_gamma(a) * _go_gamma(b) / _go_gamma(a + b))
    front = _go_exp(math.log(x) * a + math.log(1.0 - x) * b - log_beta) / a
    f, c, d = 1.0, 1.0, 0.0
    for i in range(MAX_ITERATIONS + 1):
        m = float(i // 2)
        if i == 0:
            numerator = 1.0
        elif i % 2 == 0:
            numerator = (m * (b - m) * x) / ((a + 2.0 * m - 1.0)
                                             * (a + 2.0 * m))
        else:
            numerator = -((a + m) * (a + b + m) * x) / ((a + 2.0 * m)
                                                        * (a + 2.0 * m + 1))
        d = 1.0 + numerator * d
        if abs(d) < SMALL:
            d = SMALL
        d = 1.0 / d
        c = 1.0 + numerator / c
        if abs(c) < SMALL:
            c = SMALL
        f *= c * d
        if abs(1.0 - (c * d)) < REL_ERROR:
            return front * (f - 1.0)
    raise ArithmeticError("incomplete beta failed to converge")


def negative_binomial_cdf(x: float, r: float, p: float) -> float:
    """numbers.NegativeBinomialCdf (incompleteBeta.go:10)."""
    return regularized_incomplete_beta(r, x + 1, p)


def poisson_left_summation(k: int, lam: float) -> float:
    """P(X <= k)."""
    return math.fsum(poisson_dist(i, lam) for i in range(0, k + 1))


def poisson_right_summation(k: int, lam: float) -> float:
    """P(X >= k)."""
    return 1.0 - poisson_left_summation(k - 1, lam) if k > 0 else 1.0

def binomial_left_summation(n: int, k: int, p: float) -> float:
    return math.fsum(binomial_dist(n, i, p) for i in range(0, k + 1))


def binomial_right_summation(n: int, k: int, p: float) -> float:
    return math.fsum(binomial_dist(n, i, p) for i in range(k, n + 1))


def normal_cdf(x: float, mu: float, sigma: float) -> float:
    return 0.5 * (1 + math.erf((x - mu) / (sigma * math.sqrt(2))))


def pearson(x, y) -> float:
    """numbers.Pearson (stat.go)."""
    import numpy as np

    x = np.asarray(x, float)
    y = np.asarray(y, float)
    xc = x - x.mean()
    yc = y - y.mean()
    return float((xc * yc).sum()
                 / math.sqrt((xc * xc).sum() * (yc * yc).sum()))


# --- Romberg integration + distribution integrals (numbers/integrate.go,
# distribution.go) ---

def rombergs_method(f, a: float, b: float, estimated_error: float,
                    relative_est_error: float, max_iter: int) -> float:
    """integrate.go:67 rombergsMethod, literal recurrence so converged
    values match the reference float-for-float."""
    prev_r = [0.0] * max_iter
    curr_r = [0.0] * max_iter
    min_iter = 10
    prev_r[0] = 0.5 * (f(a) + f(b))
    for n in range(1, max_iter):
        h = math.ldexp(b - a, -n)
        curr_r[0] = 0.0
        k_max = int(math.ldexp(1.0, n - 1))
        for k in range(1, k_max + 1):
            curr_r[0] += f(a + (2 * k - 1) * h)
        curr_r[0] *= h
        curr_r[0] += 0.5 * prev_r[0]
        for m in range(1, n + 1):
            curr_r[m] = curr_r[m - 1] + 1 / (math.pow(4, m) - 1) \
                * (curr_r[m - 1] - prev_r[m - 1])
        curr_est_error = abs(curr_r[n] - prev_r[n - 1])
        if (curr_est_error < estimated_error
                or curr_est_error < relative_est_error * abs(curr_r[n])) \
                and n >= min_iter:
            return curr_r[n]
        prev_r, curr_r = curr_r, prev_r
    raise ArithmeticError("Romberg's method did not converge.")


def definite_integral(f, start: float, end: float) -> float:
    return rombergs_method(f, start, end, 1e-8, 1e-8, 30)


def definite_small_integral(f, start: float, end: float) -> float:
    return rombergs_method(f, start, end, 0.0, 1e-6, 30)


def normal_adaptive_integral(left: str, right: str, mu: float,
                             sigma: float) -> float:
    """numbers.NormalAdaptiveIntegral (distribution.go:164) with the
    reference's +-6/38 sigma tail shortcuts."""
    def f(x):
        return normal_dist(x, mu, sigma)
    left_inf = left in ("-INF", "-Inf", "-inf")
    right_inf = right in ("INF", "Inf", "inf")
    if left_inf and right_inf:
        return 1.0
    if not left_inf and not right_inf:
        return definite_small_integral(f, float(left), float(right))
    if left_inf:
        r = float(right)
        if r > mu + 6 * sigma:
            return 1.0
        if r < mu - 38 * sigma:
            return 0.0
        if r > mu - 3 * sigma:
            return definite_small_integral(f, r - 15 * sigma, r)
        return definite_small_integral(f, r - 10 * sigma, r)
    lf = float(left)
    if lf < mu - 6 * sigma:
        return 1.0
    if lf > mu + 38 * sigma:
        return 0.0
    if lf < mu + 10 * sigma:
        return definite_small_integral(f, lf, lf + 15 * sigma)
    return definite_small_integral(f, lf, lf + 10 * sigma)


def beta_integral(left: float, right: float, alpha: float,
                  beta: float) -> float:
    return definite_integral(lambda x: beta_dist(x, alpha, beta),
                             left, right)


def gamma_integral(left: float, right: float, alpha: float,
                   beta: float) -> float:
    return definite_integral(lambda x: gamma_dist(x, alpha, beta),
                             left, right)


def gamma_left_integral(x: float, alpha: float, beta: float) -> float:
    return definite_integral(lambda v: gamma_dist(v, alpha, beta), 0, x)


def gamma_right_integral(x: float, alpha: float, beta: float) -> float:
    return 1 - gamma_left_integral(x, alpha, beta)


def poisson_sum(left: int, right: int, lam: float) -> float:
    """numbers.PoissonSum (distribution.go:266): the reference rejects
    right > left then iterates left..right-1 (an always-empty range for
    valid input) — preserved for parity."""
    if right > left:
        raise ValueError("PoissonSum: right must be lower than left")
    return sum(poisson_dist(i, lam) for i in range(left, right))


def binomial_sum(left: int, right: int, n: int, p: float) -> float:
    """numbers.BinomialSum (distribution.go:307): the left term is
    double-counted (answer seeded with dist(left) before the inclusive
    loop) — preserved for parity."""
    if right < left:
        raise ValueError("BinomialSum: right must be greater than left")
    answer = binomial_dist(n, left, p)
    for i in range(left, right + 1):
        answer += binomial_dist(n, i, p)
    return answer


def fast_rejection_sampler(x_left: float, x_right: float, f, bins: int,
                           max_sample_depth: int, samples: int, rng=None):
    """numbers.FastRejectionSampler (monteCarlo.go:48) with numpy
    uniforms (the Go rand stream is not reproducible)."""
    import numpy as np

    rng = np.random.default_rng() if rng is None else rng
    step = (x_right - x_left) / bins
    edges = x_left + step * np.arange(bins)
    heights = np.array([max(f(e), f(e + step)) for e in edges])
    cum = np.cumsum(heights / heights.sum())
    out = np.empty(samples)
    for j in range(samples):
        for _ in range(max_sample_depth):
            b = int(np.searchsorted(cum, rng.random(), side="right"))
            b = min(b, bins - 1)
            x = x_left + b * step + rng.random() * step
            if rng.random() * heights[b] < f(x):
                out[j] = x
                break
        else:
            raise ArithmeticError("exceeded max iteration in rejection "
                                  "sampler")
    return out
