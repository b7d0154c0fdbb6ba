"""Bit-exact copies of Go's ``math.Log`` and ``math.Log2`` (FDLIBM
lineage): a copy of ``gonomics_tpu/numbers/gomath.py`` (57 lines,
whole), on which pFaTools' entropy track depends to the last ulp.

go_log replicates Go's math.Log (src/math/log.go, FDLIBM e_log.c) and
go_log2 replicates math.Log2 (frexp decomposition + exact powers of two),
so scores formatted with %v round-trip identically to the reference.
"""

from __future__ import annotations

import math

_L1 = 6.666666666666735130e-01
_L2 = 3.999999999940941908e-01
_L3 = 2.857142874366239149e-01
_L4 = 2.222219843214978396e-01
_L5 = 1.818357216161805012e-01
_L6 = 1.531383769920937332e-01
_L7 = 1.479819860511658591e-01
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_SQRT2_OVER_2 = 0.7071067811865476  # math.Sqrt2 / 2 rounded to float64
_INV_LN2 = 1.4426950408889634073599246810018921  # 1 / Ln2 as float64


def go_log(x: float) -> float:
    """Go math.Log — FDLIBM __ieee754_log, deterministic float ops."""
    if math.isnan(x) or (math.isinf(x) and x > 0):
        return x
    if x < 0:
        return math.nan
    if x == 0:
        return -math.inf
    f1, ki = math.frexp(x)
    if f1 < _SQRT2_OVER_2:
        f1 *= 2
        ki -= 1
    f = f1 - 1
    k = float(ki)
    s = f / (2 + f)
    s2 = s * s
    s4 = s2 * s2
    t1 = s2 * (_L1 + s4 * (_L3 + s4 * (_L5 + s4 * _L7)))
    t2 = s4 * (_L2 + s4 * (_L4 + s4 * _L6))
    r = t1 + t2
    hfsq = 0.5 * f * f
    return k * _LN2_HI - ((hfsq - (s * (hfsq + r) + k * _LN2_LO)) - f)


def go_log2(x: float) -> float:
    """Go math.Log2: exact for powers of two, else Log(frac)/Ln2 + exp."""
    if x <= 0 or math.isnan(x) or math.isinf(x):
        return go_log(x) * _INV_LN2
    frac, exp = math.frexp(x)
    if frac == 0.5:
        return float(exp - 1)
    return go_log(frac) * _INV_LN2 + float(exp)
