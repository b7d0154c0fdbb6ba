"""Random-variate samplers with gonomics' exact draw sequences, a copy
of ``gonomics_tpu/numbers/gosamplers.py`` (227 lines, whole), gonomics'
``numbers/{randExp,randBeta,randBinomial,monteCarlo}.go``.

Each draws from the bit-exact Go rand stream (``numbers/gorand``), so
that every accept/reject decision, and therefore every downstream golden
output, matches gonomics byte for byte. ``rand_gamma`` keeps gonomics'
``gamma_dist(a, b, b * x)`` argument order.
"""

from __future__ import annotations

import math

from .distributions import beta_dist, exp_dist, gamma_dist
from .gorand import GoRand


def _exp(x: float) -> float:
    """Go math.Exp: overflows to +Inf instead of raising."""
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


def _log(x: float) -> float:
    """Go math.Log: Log(0) = -Inf, Log(x<0) = NaN."""
    if x > 0:
        return math.log(x)
    if x == 0:
        return -math.inf
    return math.nan

MAX_ITERATIONS = 10000
LN4 = 1.3862943611198906


def rand_exp(rng: GoRand):
    """numbers.RandExp (randExp.go:19): Ahrens-Dieter; returns (x, f(x))."""
    q = [0.6931471805599453, 0.9333736875190459, 0.9888777961838675,
         0.9984959252914960, 0.9998292811061389, 0.9999833164100727,
         0.9999985691438767, 0.9999998906925558, 0.9999999924734159,
         0.9999999995283275, 0.9999999999728814, 0.9999999999985598,
         0.9999999999999289, 0.9999999999999968, 0.9999999999999999,
         1.0000000000000000]
    a = 0.0
    r = rng.float64()
    while r <= 0.0 or r >= 1.0:
        r = rng.float64()
    while True:
        r += r
        if r > 1.0:
            break
        a += q[0]
    r -= 1
    if r <= q[0]:
        return a + r, exp_dist(a + r)
    i = 0
    ustart = rng.float64()
    umin = ustart
    while r > q[i]:
        ustart = rng.float64()
        if umin > ustart:
            umin = ustart
        i += 1
    return a + umin * q[0], exp_dist(a + umin * q[0])


def rand_beta(rng: GoRand, a: float, b: float) -> float:
    """numbers.RandBeta (randBeta.go:23): Cheng's BA algorithm."""
    alpha = a + b
    if min(a, b) <= 1:
        beta = max(1.0 / a, 1.0 / b)
    else:
        beta = math.sqrt((alpha - 2.0) / (2 * a * b - alpha))
    gamma = a + 1.0 / beta
    for _ in range(MAX_ITERATIONS):
        u1 = rng.float64()
        u2 = rng.float64()
        v = beta * _log(u1 / (1 - u1))
        w = a * _exp(v)
        if alpha * _log(alpha / (b + w)) + gamma * v - LN4 < \
                _log(u1 * u1 * u2):
            continue
        return w / (b + w)
    raise RuntimeError("RandBeta: no accepted value in max iterations")


def rand_gamma(rng: GoRand, a: float, b: float):
    """numbers.RandGamma (monteCarlo.go:141): Marsaglia-Tsang (a>=1) /
    Ahrens-Dieter (a<1); returns (x, f(x))."""
    if a < 0 or b < 0:
        raise ValueError("gamma parameters must be greater than zero")
    b = 1 / b
    if a < 1:
        e1 = 0.36787944117144232159
        e = 1.0 + e1 * a
        while True:
            p = e * rng.float64()
            r_exp, _ = rand_exp(rng)
            if p >= 1.0:
                x = -1 * math.log((e - p) / a)
                if r_exp >= (1.0 - a) * math.log(x):
                    break
            else:
                x = math.exp(math.log(p) / a)
                if r_exp >= x:
                    break
        return b * x, gamma_dist(a, b, b * x)  # verbatim arg order (monteCarlo.go:169)

    d = a - (1.0 / 3.0)
    c = (1.0 / 3.0) / math.sqrt(d)
    while True:
        x = rng.norm_float64()
        v = 1.0 + c * x
        while v <= 0:
            x = rng.norm_float64()
            v = 1.0 + c * x
        v = v * v * v
        u = rng.float64()
        if u < 1 - 0.0331 * x * x * x * x:
            break
        if math.log(u) < 0.5 * x * x + d * (1 - v + math.log(v)):
            break
    return b * d * v, gamma_dist(a, b, b * d * v)  # verbatim (monteCarlo.go:190)


def rand_int_in_range(rng: GoRand, x: int, y: int) -> int:
    """numbers.RandIntInRange (random.go:9): int(Float64()*(y-x)) + x."""
    return int(rng.float64() * float(y - x)) + x


def rand_geometric(rng: GoRand, p: float) -> int:
    """numbers.RandGeometric (randExp.go:12): inverse transform,
    support 0..+Inf."""
    r = rng.float64()
    return int(math.floor(_log(1 - r) / _log(1 - p)))


def sample_inverse_normal(rng: GoRand, mu: float, sigma: float) -> float:
    """numbers.SampleInverseNormal (monteCarlo.go:10)."""
    return rng.norm_float64() * sigma + mu


class BinomialAlias:
    """numbers.BinomialAlias (randBinomial.go:14): Vose alias table for
    Binom(n, p), built with the reference's exact float ops so that stack
    membership (> 1/(n+1) comparisons) — and therefore the Alias table —
    matches bit-for-bit."""

    __slots__ = ("probability", "alias")

    def __init__(self, probability: list[float], alias: list[int]):
        self.probability = probability
        self.alias = alias


def make_binomial_alias(n: int, p: float) -> BinomialAlias:
    """numbers.MakeBinomialAlias (randBinomial.go:36). Deterministic (no
    rand draws); probabilities below the float underflow threshold
    truncate to 0 exactly as the reference's BinomialDist does."""
    from . import binomial_dist_log
    from . import logspace as _ls

    one_over = 1.0 / float(n + 1)
    prob = [0.0] * (n + 1)
    alias = [0] * (n + 1)
    for k in range(n + 1):
        log_p = binomial_dist_log(n, k, p)
        prob[k] = math.exp(log_p) if _ls.can_convert(log_p) else 0.0
    under: list[int] = []
    over: list[int] = []
    for k in range(n + 1):
        (over if prob[k] > one_over else under).append(k)
    while over and under:
        cu = under[-1]
        co = over[-1]
        empty = one_over - prob[cu]
        alias[cu] = co
        under.pop()
        prob[co] -= empty
        if prob[co] < one_over:
            under.append(co)
            over.pop()
    while over:
        prob[over.pop()] = one_over
    while under:
        prob[under.pop()] = one_over
    for k in range(n + 1):
        prob[k] = prob[k] * float(n + 1)
    return BinomialAlias(prob, alias)


def rand_binomial(rng: GoRand, alias: BinomialAlias) -> int:
    """numbers.RandBinomial (randBinomial.go:22): one RandIntInRange draw
    then one Float64 draw."""
    index = rand_int_in_range(rng, 0, len(alias.probability))
    if rng.float64() < alias.probability[index]:
        return index
    return alias.alias[index]


def scaled_beta_sampler(rng: GoRand, a: float, b: float,
                        multiplier: float):
    """numbers.ScaledBetaSampler (monteCarlo.go:123)."""
    def sampler():
        answer = rand_beta(rng, a, b)
        try:
            y = multiplier * beta_dist(answer, a, b)
        except (OverflowError, ZeroDivisionError):
            y = math.inf  # Go: math.Pow overflows / Pow(0, -x) = +Inf
        return answer, y
    return sampler


def bounded_rejection_sample(rng: GoRand, bounding_sampler, f,
                             x_left: float, x_right: float,
                             max_iteration: int):
    """numbers.BoundedRejectionSample (monteCarlo.go:106)."""
    for _ in range(max_iteration):
        x_s, y_s = bounding_sampler()
        y = f(x_s)
        if y > y_s:
            raise RuntimeError("BoundedRejectionSample: invalid bounding "
                               "function")
        if rng.float64() * y_s < y:
            return x_s, y
    raise RuntimeError("BoundedRejectionSample: exceeded max iteration")
