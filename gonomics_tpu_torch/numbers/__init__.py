"""Fisher's exact test and the binomial tail: the subset of
``gonomics_tpu/numbers/__init__.py`` that the variant caller (:16-72)
and faFindFast (:74-115) use, the same float64 steps in the same order,
so that every p value is bit for bit the JAX package's. ``logspace`` is
a copy of the JAX's module of that name; ``matrix`` holds the fractional
matrix powers of the substitution matrices; ``gorand`` (Go's
``math/rand``), ``distributions``, ``gosamplers`` and ``fit`` are whole
copies of the JAX's modules of those names."""

from __future__ import annotations

import math
import sys

from . import logspace


def _careful_mult_div_float(numer: list[float], denom: list[float]) -> float:
    """numbers.carefulMultDivFloat (numbers.go:16-40): interleaves
    multiplies and divides to avoid overflow; exact evaluation order is
    preserved so downstream float output matches."""
    answer = 1.0
    i = j = 0
    while i < len(numer) or j < len(denom):
        if (answer <= 1 and i < len(numer)) or j == len(denom):
            if sys.float_info.max / numer[i] < answer:
                raise OverflowError("carefulMultDiv overflow")
            answer *= numer[i]
            i += 1
        else:
            if 5e-324 * denom[j] > answer:
                if i == len(numer):
                    return 5e-324
                raise OverflowError("carefulMultDiv underflow")
            answer /= denom[j]
            j += 1
    return answer


def _fisher_prob_less(a: int, b: int, c: int, d: int) -> float:
    n = a + b + c + d
    numer: list[float] = []
    for w in range(a + 1, a + b + 1):
        numer.append(float(w))
    for x in range(d + 1, c + d + 1):
        numer.append(float(x))
    for y in range(c + 1, a + c + 1):
        numer.append(float(y))
    for z in range(b + 1, b + d + 1):
        numer.append(float(z))
    denom = [float(j) for j in range(1, n + 1)]
    return _careful_mult_div_float(numer, denom)


def _fisher_exact_less(a: int, b: int, c: int, d: int) -> float:
    curr = _fisher_prob_less(a, b, c, d)
    total = curr
    while a > 0 and d > 0:
        a -= 1
        b += 1
        c += 1
        d -= 1
        curr = curr * float(a + 1) / float(c) * float(d + 1) / float(b)
        total += curr
    return total


def fisher_exact(a: int, b: int, c: int, d: int, a_small: bool) -> float:
    """numbers.FisherExact (numbers.go:127): one-sided Fisher's exact test
    on [[a, b], [c, d]]."""
    if a_small:
        return _fisher_exact_less(a, b, c, d)
    return _fisher_exact_less(c, d, a, b)



def binom_coefficient_log(n: int, k: int) -> float:
    """ln C(n, k), with the reference's summation order
    (numbers.go:163-183)."""
    if n < 0 or k < 0 or k > n:
        raise ValueError(f"bad binomial coefficient n={n} k={k}")
    if n - k > k:
        k = n - k
    if k == n:
        return 0.0
    numer = 0.0
    denom = 0.0
    for x in range(k + 1, n + 1):
        numer = logspace.multiply(numer, math.log(float(x)))
    for y in range(2, n - k + 1):
        denom = logspace.multiply(denom, math.log(float(y)))
    return logspace.divide(numer, denom)


def binomial_expression_log(n: int, k: int, p: float) -> float:
    s = logspace.pow_(logspace.go_log(p), float(k))
    f = logspace.pow_(logspace.go_log(1.0 - p), float(n - k))
    return logspace.multiply(s, f)


def binomial_dist_log(n: int, k: int, p: float) -> float:
    """ln P(X == k) for X ~ Binom(n, p) (logDistribution.go:11)."""
    return logspace.multiply(binom_coefficient_log(n, k),
                             binomial_expression_log(n, k, p))


def binomial_dist_cache_log10(n: int, p: float) -> dict[int, float]:
    """map k -> -log10 P(X >= k), the faFindFast p-value cache
    (cmd/faFindFast/efficient.go binomialDistCacheLog10)."""
    if p < 0 or p > 1:
        raise ValueError("p must be between 0 and 1")
    answer: dict[int, float] = {n: binomial_dist_log(n, n, p)}
    for k in range(n - 1, -1, -1):
        answer[k] = logspace.add(binomial_dist_log(n, k, p), answer[k + 1])
    for k in range(n + 1):
        answer[k] = -1 * logspace.to_base10(answer[k])
    answer[0] = 0.0  # hardcoded to avoid numerical noise (reference does too)
    return answer
