"""Bit-exact emulation of Go's math/rand default source, a copy of
``gonomics_tpu/numbers/gorand.py`` (408 lines, whole).

Go's rand.Source is a 607-word additive lagged-Fibonacci generator
(taps 273/607) whose Seed() XORs a Park-Miller LCG stream against a
constant table ("rngCooked" in Go's rng.go: the generator state after a
long burn-in from a fixed start). gonomics pins this generator
(exception.go:14-38 forces rand.Seed(0); cmds take -setSeed), so its
golden outputs are functions of this exact stream.

The burn-in table ``_gorand_cooked.npy`` (607 uint64) lies beside this
module, a byte-for-byte copy of the JAX package's. It is rebuilt by
jump-ahead: the recurrence is linear over Z/2^64, so advancing N steps is
t^N mod (t^607 - t^334 - 1) applied to the start state (numpy uint64
polynomial arithmetic; see ``_jump_state``), and
``compute_cooked(7_800_000_000_000)`` equals the stored table. Go's own
seed-1 stream is the oracle: ``GoRand(1).int63()`` is
5577006791947779410.
"""

from __future__ import annotations

import os

import numpy as np

RNG_LEN = 607
RNG_TAP = 273
INT32MAX = (1 << 31) - 1
_A, _Q, _R = 48271, 44488, 3399
_MASK63 = (1 << 63) - 1

_COOKED_PATH = os.path.join(os.path.dirname(__file__),
                            "_gorand_cooked.npy")


def _seedrand(x: int) -> int:
    """Park-Miller minimal standard generator (rng.go seedrand)."""
    hi, lo = divmod(x, _Q)
    x = _A * lo - _R * hi
    if x < 0:
        x += INT32MAX
    return x


def _gen_cooked_start() -> np.ndarray:
    """gen_cooked.go srand(1): the pre-burn-in state (shifts 20/10/0)."""
    vec = np.zeros(RNG_LEN, np.uint64)
    x = 1
    for i in range(-20, RNG_LEN):
        x = _seedrand(x)
        if i >= 0:
            u = (x << 20) & 0xFFFFFFFFFFFFFFFF
            x = _seedrand(x)
            u ^= x << 10
            x = _seedrand(x)
            u ^= x
            vec[i] = u
    return vec


def _poly_mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a*b) mod (t^607 - t^334 - 1) over Z/2^64 (wrapping uint64)."""
    with np.errstate(over="ignore"):
        c = np.convolve(a, b)  # degree <= 1212, wraps mod 2^64 naturally
        for d in range(len(c) - 1, RNG_LEN - 1, -1):
            coef = c[d]
            if coef:
                c[d - RNG_TAP] += coef   # t^607 -> t^334: d - 273
                c[d - RNG_LEN] += coef
                c[d] = 0
    return c[:RNG_LEN].copy()


def _jump_state(state: np.ndarray, n: int) -> np.ndarray:
    """Advance the output stream by n steps.

    state[i] = o_{i-606} (oldest first); the vrand stream satisfies
    o_k = o_{k-273} + o_{k-607} (tap slot = output from 273 calls ago,
    feed slot = output from 607 calls ago). Returns o_{n-606}..o_n.
    Jumping uses t^n mod f with f = t^607 - t^334 - 1 (the reciprocal
    lag: s_m = s_{m-273} + s_{m-607} => t^607 = t^334 + 1)."""
    if n < 4 * RNG_LEN:
        seq = list(int(v) for v in state)
        for _ in range(n):
            seq.append((seq[-273] + seq[-607]) & 0xFFFFFFFFFFFFFFFF)
        return np.array(seq[-RNG_LEN:], np.uint64)
    p = np.zeros(RNG_LEN, np.uint64)
    p[1] = 1  # p = t
    result = np.zeros(RNG_LEN, np.uint64)
    result[0] = 1  # result = 1
    e = n
    while e:
        if e & 1:
            result = _poly_mulmod(result, p)
        p = _poly_mulmod(p, p)
        e >>= 1
    # result = t^n mod f; coefficient c_j means o_{k+n} = sum c_j o_{k+j}
    # with o_{k}..o_{k+606} a window. Take k = -606: o_{n-606+i} needs
    # t^{n+i}; advance the polynomial by one t-multiply per lane.
    out = np.zeros(RNG_LEN, np.uint64)
    cur = result
    t_poly = np.zeros(RNG_LEN, np.uint64)
    t_poly[1] = 1
    for i in range(RNG_LEN):
        out[i] = np.sum(cur * state, dtype=np.uint64)
        if i < RNG_LEN - 1:
            cur = _poly_mulmod(cur, t_poly)
    return out


def direct_vrand_state(vec0: np.ndarray, n: int) -> np.ndarray:
    """Reference emulation of n vrand() calls on a fresh (tap=0, feed=334)
    generator; returns the final vec. Used to validate the jump path."""
    v = [int(x) for x in vec0]
    tap, feed = 0, RNG_LEN - RNG_TAP
    for _ in range(n):
        tap -= 1
        if tap < 0:
            tap += RNG_LEN
        feed -= 1
        if feed < 0:
            feed += RNG_LEN
        v[feed] = (v[feed] + v[tap]) & 0xFFFFFFFFFFFFFFFF
    return np.array(v, np.uint64)


def compute_cooked(n_steps: int) -> np.ndarray:
    """Reconstruct rngCooked: the gen_cooked start state advanced by
    n_steps vrand() calls, expressed back in vec-slot order.

    Slot mapping: the call that writes slot j is k == (334 - j) mod 607;
    initial values are o_m, m in [-606, 0], at slot (334 - m) mod 607."""
    vec0 = _gen_cooked_start()
    state = np.array([vec0[(940 - i) % RNG_LEN] for i in range(RNG_LEN)],
                     np.uint64)
    jumped = _jump_state(state, n_steps)  # o_{n-606} .. o_n
    out = np.zeros(RNG_LEN, np.uint64)
    for i in range(RNG_LEN):
        m = n_steps + i - (RNG_LEN - 1)
        out[(334 - m) % RNG_LEN] = jumped[i]
    return out


def _load_cooked() -> np.ndarray:
    return np.load(_COOKED_PATH)


class GoRand:
    """rand.Rand on Go's rngSource, bit-exact (rng.go)."""

    def __init__(self, seed: int = 1):
        self._cooked = _load_cooked()
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.tap = 0
        self.feed = RNG_LEN - RNG_TAP
        seed = seed % INT32MAX
        if seed < 0:
            seed += INT32MAX
        if seed == 0:
            seed = 89482311
        x = seed
        vec = np.zeros(RNG_LEN, np.uint64)
        cooked = self._cooked
        for i in range(-20, RNG_LEN):
            x = _seedrand(x)
            if i >= 0:
                u = (x << 40) & 0xFFFFFFFFFFFFFFFF
                x = _seedrand(x)
                u ^= x << 20
                x = _seedrand(x)
                u ^= x
                u ^= int(cooked[i])
                vec[i] = u
        self.vec = vec
        # readable-int mirror to avoid per-call numpy overhead
        self._v = [int(v) for v in vec]

    def _vrand(self) -> int:
        self.tap -= 1
        if self.tap < 0:
            self.tap += RNG_LEN
        self.feed -= 1
        if self.feed < 0:
            self.feed += RNG_LEN
        x = (self._v[self.feed] + self._v[self.tap]) & 0xFFFFFFFFFFFFFFFF
        self._v[self.feed] = x
        return x

    def int63(self) -> int:
        return self._vrand() & _MASK63

    def uint64(self) -> int:
        """rand.Uint64: two Int63 draws spliced (rand.go)."""
        return (self.int63() >> 31) | ((self.int63() << 32)
                                       & 0xFFFFFFFFFFFFFFFF)

    def uint32(self) -> int:
        return self.int63() >> 31

    def int31(self) -> int:
        return self.int63() >> 32

    def int31n(self, n: int) -> int:
        """rand.Int31n rejection sampling (rand.go:133)."""
        if n & (n - 1) == 0:
            return self.int31() & (n - 1)
        mx = (1 << 31) - 1 - ((1 << 31) % n)
        v = self.int31()
        while v > mx:
            v = self.int31()
        return v % n

    def int63n(self, n: int) -> int:
        if n & (n - 1) == 0:
            return self.int63() & (n - 1)
        mx = (1 << 63) - 1 - ((1 << 63) % n)
        v = self.int63()
        while v > mx:
            v = self.int63()
        return v % n

    def intn(self, n: int) -> int:
        """rand.Intn: Int31n when n fits in int32."""
        if n <= 0:
            raise ValueError("invalid argument to Intn")
        if n <= (1 << 31) - 1:
            return self.int31n(n)
        return self.int63n(n)

    def float64(self) -> float:
        """rand.Float64 (rand.go:179): Int63()/2^63, redrawn on 1.0."""
        while True:
            f = self.int63() / (1 << 63)
            if f != 1.0:
                return f

    def perm(self, n: int) -> list[int]:
        """rand.Perm (rand.go:226)."""
        m = [0] * n
        for i in range(1, n):
            j = self.intn(i + 1)
            m[i] = m[j]
            m[j] = i
        return m

    def _int31n_lemire(self, n: int) -> int:
        """rand's PRIVATE int31n (rand.go:119): Lemire's multiply-shift
        on Uint32 draws — used by Shuffle, unlike the exported Int31n."""
        v = self.uint32()
        prod = v * n
        low = prod & 0xFFFFFFFF
        if low < n:
            thresh = ((1 << 32) - n) % n
            while low < thresh:
                v = self.uint32()
                prod = v * n
                low = prod & 0xFFFFFFFF
        return prod >> 32

    def shuffle(self, n: int, swap) -> None:
        """rand.Shuffle (rand.go:232)."""
        if n < 0:
            raise ValueError("invalid argument to Shuffle")
        i = n - 1
        while i > (1 << 31) - 1 - 1:
            j = self.int63n(i + 1)
            swap(i, j)
            i -= 1
        while i > 0:
            j = self._int31n_lemire(i + 1)
            swap(i, j)
            i -= 1

    def norm_float64(self) -> float:
        """rand.NormFloat64 (normal.go:38): Ziggurat algorithm."""
        import math

        while True:
            j = self.uint32()
            # interpret as int32
            if j >= 1 << 31:
                j_signed = j - (1 << 32)
            else:
                j_signed = j
            i = j & 0x7F
            # Go's tables are [128]float32 and the rejection test runs in
            # float32 (normal.go:42,55) — replicate with np.float32
            x = j_signed * float(_WN[i])
            if abs(j_signed) < _KN[i]:
                return x
            if i == 0:
                while True:
                    x = -math.log(self.float64()) * (1.0 / _RN)
                    y = -math.log(self.float64())
                    if y + y >= x * x:
                        break
                x += _RN
                if j_signed > 0:
                    return x
                return -x
            if _FN[i] + np.float32(self.float64()) * (_FN[i - 1] - _FN[i]) \
                    < np.float32(math.exp(-0.5 * x * x)):
                return x

    def exp_float64(self) -> float:
        """rand.ExpFloat64 (exp.go:30): Ziggurat algorithm."""
        import math

        while True:
            j = self.uint32()
            i = j & 0xFF
            # float32 tables + float32 rejection test (exp.go:36,46)
            x = j * float(_WE[i])
            if j < _KE[i]:
                return x
            if i == 0:
                return _RE - math.log(self.float64())
            if _FE[i] + np.float32(self.float64()) * (_FE[i - 1] - _FE[i]) \
                    < np.float32(math.exp(-x)):
                return x


# ziggurat tables are computed at import (cheap, exact float64 math
# mirroring Go's normal.go/exp.go init functions)
_RN = 3.442619855899


def _norm_tables():
    import math

    m1 = 1 << 31
    vn = 9.91256303526217e-3
    dn = _RN
    tn = dn
    kn = [0] * 128
    wn = [0.0] * 128
    fn = [0.0] * 128
    q = vn / math.exp(-0.5 * dn * dn)
    kn[0] = int((dn / q) * m1)
    kn[1] = 0
    wn[0] = q / m1
    wn[127] = dn / m1
    fn[0] = 1.0
    fn[127] = math.exp(-0.5 * dn * dn)
    for i in range(126, 0, -1):
        dn = math.sqrt(-2.0 * math.log(vn / dn + math.exp(-0.5 * dn * dn)))
        kn[i + 1] = int((dn / tn) * m1)
        tn = dn
        fn[i] = math.exp(-0.5 * dn * dn)
        wn[i] = dn / m1
    # Go hardcodes wn/fn as [128]float32 literals (normal.go:88-157)
    return kn, np.float32(wn), np.float32(fn)


_KN, _WN, _FN = _norm_tables()
_RE = 7.69711747013104972


def _exp_tables():
    import math

    m2 = 1 << 32
    ve = 3.949659822581572e-3
    de = _RE
    te = de
    ke = [0] * 256
    we = [0.0] * 256
    fe = [0.0] * 256
    q = ve / math.exp(-de)
    ke[0] = int((de / q) * m2)
    ke[1] = 0
    we[0] = q / m2
    we[255] = de / m2
    fe[0] = 1.0
    fe[255] = math.exp(-de)
    for i in range(254, 0, -1):
        de = -math.log(ve / de + math.exp(-de))
        ke[i + 1] = int((de / te) * m2)
        te = de
        fe[i] = math.exp(-de)
        we[i] = de / m2
    # Go hardcodes we/fe as [256]float32 literals (exp.go:61-221)
    return ke, np.float32(we), np.float32(fe)


_KE, _WE, _FE = _exp_tables()


# module-level instance mirroring Go's global rand (exception.go pins
# rand.Seed(0) repo-wide; cmds re-seed via -setSeed)
_global: GoRand | None = None


def seed(s: int) -> None:
    global _global
    if _global is None:
        _global = GoRand(s)
    else:
        _global.seed(s)


def default() -> GoRand:
    global _global
    if _global is None:
        _global = GoRand(0)
    return _global
