"""Fisher's exact test: the subset of ``gonomics_tpu/numbers/__init__.py``
(:16-72) that the variant caller uses, the same float64 steps in the same
order, so that every p value is bit for bit the JAX package's."""

from __future__ import annotations

import sys


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

