"""Natural-log-space arithmetic: a literal copy of
``gonomics_tpu/numbers/logspace.py`` (73 lines), gonomics'
``numbers/logspace`` with its guard thresholds, so that faFindFast's
``-longOutput`` p values are bit for bit the JAX package's."""

from __future__ import annotations

import math

NEG_INF = float("-inf")


def go_log(x: float) -> float:
    """Go math.Log semantics: Log(0) = -Inf, Log(x<0) = NaN."""
    if x > 0:
        return math.log(x)
    if x == 0:
        return NEG_INF
    return float("nan")


def can_convert(x: float) -> bool:
    return -745.1 < x < 709.4


def to_base10(ln_x: float) -> float:
    return ln_x * math.log10(math.e)


def add(x: float, y: float) -> float:
    if x == NEG_INF:
        return y
    if y == NEG_INF:
        return x
    if x >= y:
        if can_convert(y - x):
            return x + math.log1p(math.exp(y - x))
        return x
    if can_convert(x - y):
        return y + math.log1p(math.exp(x - y))
    return y


def subtract(x: float, y: float) -> float:
    if x < y:
        raise ValueError("taking the log of a negative number")
    if x == y:
        return NEG_INF
    if y == NEG_INF:
        return x
    if can_convert(y - x):
        return x + math.log(1 - math.exp(y - x))
    return x


def multiply(x: float, y: float) -> float:
    if x == NEG_INF or y == NEG_INF:
        return NEG_INF
    return x + y


def divide(x: float, y: float) -> float:
    if y == NEG_INF:
        raise ZeroDivisionError("divide by zero in logspace")
    if x == NEG_INF:
        return NEG_INF
    return x - y


def pow_(x: float, y: float) -> float:
    """log(exp(x)**y); 0^0 -> log(1) = 0 (logspace.go Pow)."""
    if y == 0.0:
        return 0.0
    return y * x
