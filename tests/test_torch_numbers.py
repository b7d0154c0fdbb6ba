"""The port's ``numbers/gorand.py``, ``distributions.py``,
``gosamplers.py`` and ``fit.py`` (gonomics_tpu_torch/numbers/) on the CPU
against the JAX package's modules of those names: the same inputs, built
from a seed, through both sides. Equal means bit for bit: floats by their
64 bits, NaN positions equal; exceptions by type and message; generators
by their 607 words, ``tap`` and ``feed`` after the draws. Go's own
published seed-1 stream is an oracle of its own.
"""

import math
import os
import struct

import numpy as np
import pytest

from gonomics_tpu.numbers import distributions as jdist
from gonomics_tpu.numbers import fit as jfit
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu.numbers import gosamplers as jsamp
from gonomics_tpu_torch.numbers import distributions as tdist
from gonomics_tpu_torch.numbers import fit as tfit
from gonomics_tpu_torch.numbers import gorand as tgr
from gonomics_tpu_torch.numbers import gosamplers as tsamp

SEEDS = [-7, -1, 0, 1, 10, 2**31 - 1, 2**31, 2**40]
NS = [1, 2, 3, 100, 2**31 - 1, 2**40]
DRAWS = 2000


def _bits(x):
    """x with every float as its 64 bits (NaN as one token), recursively,
    so that == is bit-for-bit equality."""
    if isinstance(x, (float, np.floating)):
        return "nan" if math.isnan(x) else struct.pack("<d", float(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, _bits(x.tolist()))
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_bits(v) for v in x]
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    return type(x).__name__, x


def _outcome(fn, *args, **kw):
    """fn's value as _bits, or the type and message of what it raised."""
    try:
        return "ok", _bits(fn(*args, **kw))
    except Exception as e:
        return "raise", type(e).__name__, str(e)


def _state(rng):
    return rng._v, rng.tap, rng.feed


def _pair(seed):
    return jgr.GoRand(seed), tgr.GoRand(seed)


# --- gorand ---

def _draw(rng, method):
    if method in ("int31n", "int63n", "intn"):
        ns = NS if method != "int31n" else NS[:-1]
        return [getattr(rng, method)(n) for n in ns for _ in range(DRAWS)]
    if method == "perm_shuffle":
        out = [rng.perm(50) for _ in range(DRAWS // 50)]
        items = list(range(50))

        def swap(i, j):
            items[i], items[j] = items[j], items[i]

        for _ in range(DRAWS // 50):
            rng.shuffle(len(items), swap)
            out.append(list(items))
        return out
    return [getattr(rng, method)() for _ in range(DRAWS)]


@pytest.mark.parametrize("method", ["int63", "uint64", "uint32", "int31",
                                    "float64", "norm_float64",
                                    "exp_float64", "int31n", "int63n",
                                    "intn", "perm_shuffle"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gorand_stream_equal(seed, method):
    """2,000 draws of each method (each n of NS for the bounded ones),
    and the generator's state after them."""
    j, t = _pair(seed)
    assert _state(t) == _state(j)
    assert _bits(_draw(t, method)) == _bits(_draw(j, method))
    assert _state(t) == _state(j)


def test_gorand_go_seed1_oracle():
    """Go's published seed-1 values: rand.Int63, ten rand.Intn(100) and
    the first three Float64."""
    assert tgr.GoRand(1).int63() == 5577006791947779410
    rng = tgr.GoRand(1)
    assert [rng.intn(100) for _ in range(10)] == [81, 87, 47, 59, 81, 18,
                                                  25, 40, 56, 0]
    rng = tgr.GoRand(1)
    assert [rng.float64() for _ in range(3)] == [
        0.6046602879796196, 0.9405090880450124, 0.6645600532184904]


@pytest.mark.parametrize("n", [2500, 6071])
def test_gorand_jump_equals_direct(n):
    vec0 = tgr._gen_cooked_start()
    assert (vec0 == jgr._gen_cooked_start()).all()
    got = tgr.compute_cooked(n)
    assert got.dtype == np.uint64
    assert (got == tgr.direct_vrand_state(vec0, n)).all()
    assert (got == jgr.compute_cooked(n)).all()


def test_gorand_cooked_table_is_the_ports_own():
    """The port loads its own copy of the burn-in table, byte-equal to the
    JAX's, equal to the jump-ahead rebuild of Go's 7.8e12 steps."""
    here = os.path.dirname(os.path.abspath(tgr.__file__))
    assert os.path.dirname(os.path.abspath(tgr._COOKED_PATH)) == here
    with open(tgr._COOKED_PATH, "rb") as a, open(jgr._COOKED_PATH, "rb") as b:
        assert a.read() == b.read()
    cooked = tgr._load_cooked()
    assert cooked.dtype == np.uint64 and cooked.shape == (607,)
    assert (cooked == jgr._load_cooked()).all()
    assert (cooked == tgr.compute_cooked(7_800_000_000_000)).all()


def test_gorand_ziggurat_tables_equal():
    for name in ("_KN", "_WN", "_FN", "_KE", "_WE", "_FE"):
        got, want = getattr(tgr, name), getattr(jgr, name)
        assert _bits(got) == _bits(want), name
    assert tgr._WN.dtype == tgr._FE.dtype == np.float32


def test_gorand_seed_rules_and_module_default():
    """seed % INT32MAX, a negative seed raised by INT32MAX, 0 as 89482311;
    the module-level generator, seeded on both sides first."""
    for a, b in ((0, 89482311), (-5, 2**31 - 1 - 5), (7, 7 + 2**31 - 1)):
        assert tgr.GoRand(a)._v == tgr.GoRand(b)._v
    tgr.seed(42)
    jgr.seed(42)
    assert tgr.default() is tgr.default()
    assert tgr.default() is not jgr.default()
    assert _bits(_draw(tgr.default(), "float64")) == \
        _bits(_draw(jgr.default(), "float64"))
    assert _state(tgr.default()) == _state(jgr.default())
    for mod in (tgr, jgr):
        with pytest.raises(ValueError, match="invalid argument to Intn"):
            mod.GoRand(1).intn(0)
        with pytest.raises(ValueError, match="invalid argument to Shuffle"):
            mod.GoRand(1).shuffle(-1, None)


# --- distributions ---

def _f_norm(x):
    return math.exp(-x * x)


INF_LEFT = ["-INF", "-Inf", "-inf"]
INF_RIGHT = ["INF", "Inf", "inf"]
DIST_CASES = {
    "normal_dist": [(x, mu, s) for x in (-3.0, 0.0, 0.7, 12.0)
                    for mu, s in ((0, 1), (1.5, 0.3))],
    "standard_normal_dist": [(x,) for x in (-40.0, -1.0, 0.0, 2.5)],
    "binomial_dist": [(n, k, p) for n in (0, 1, 7, 60) for k in (0, 1, n)
                      if k <= n for p in (0.0, 1e-9, 0.3, 0.5, 1.0)],
    "negative_binomial_dist": [(k, r, p) for k in (0, 3, 40)
                               for r in (0.5, 2.0, 7.0) for p in (0.1, 0.6)],
    "geometric_dist": [(k, p) for k in (0, 5) for p in (0.2, 0.9)],
    "exp_dist": [(x,) for x in (0.0, 1.3, 800.0)],
    "poisson_dist": [(k, lam) for k in (-1, 0, 4, 30) for lam in (0.5, 9.0)],
    "beta_func": [(x, y) for x in (0.5, 2.0, 30.0) for y in (0.1, 4.0)],
    "beta_dist": [(x, a, b) for x in (-0.1, 0.0, 0.25, 1.0, 1.2)
                  for a, b in ((2.0, 3.0), (0.5, 0.5))],
    "gamma_dist": [(x, a, b) for x in (-1.0, 0.0, 0.4, 6.0)
                   for a, b in ((0.5, 2.0), (3.0, 1.0))],
    "negative_binomial_log_dist": [(k, r, p) for k in (0, 2, 25)
                                   for r in (0.7, 5.0) for p in (0.2, 0.8)],
    "_go_gamma": [(x,) for x in (0.5, 5.0, 171.0, 172.0, 200.0)],
    "_go_log": [(x,) for x in (math.nan, -1.0, 0.0, 1e-300, 3.0)],
    "_go_exp": [(x,) for x in (math.nan, -1000.0, 0.0, 709.0, 710.0)],
    "regularized_incomplete_beta": [
        (a, b, x) for a, b in ((2.0, 3.0), (0.5, 0.5), (30.0, 4.0),
                               (200.0, 200.0))
        for x in (0.01, 0.3, 0.6, 0.99)],
    "negative_binomial_cdf": [(x, r, p) for x in (0.0, 3.0, 20.0)
                              for r in (1.0, 4.5) for p in (0.3, 0.7)],
    "poisson_left_summation": [(k, lam) for k in (0, 5, 40)
                               for lam in (0.2, 6.0)],
    "poisson_right_summation": [(k, lam) for k in (0, 1, 7)
                                for lam in (0.2, 6.0)],
    "binomial_left_summation": [(n, k, p) for n, k in ((10, 0), (10, 4),
                                                       (50, 50))
                                for p in (0.1, 0.5)],
    "binomial_right_summation": [(n, k, p) for n, k in ((10, 0), (10, 4),
                                                        (50, 50))
                                 for p in (0.1, 0.5)],
    "normal_cdf": [(x, mu, s) for x in (-2.0, 0.0, 3.3)
                   for mu, s in ((0, 1), (1.0, 2.0))],
    "definite_integral": [(_f_norm, a, b) for a, b in ((0.0, 1.0),
                                                       (-2.0, 3.0))],
    "definite_small_integral": [(_f_norm, a, b) for a, b in ((0.0, 1.0),
                                                             (-5.0, 0.5))],
    "rombergs_method": [(_f_norm, 0.0, 1.0, 1e-8, 1e-8, 5),
                        (_f_norm, 0.0, 2.0, 1e-10, 0.0, 20)],
    "normal_adaptive_integral": [("-1", "2", 0.0, 1.0),
                                 ("-INF", "inf", 0.0, 1.0)],
    "beta_integral": [(0.0, 1.0, 2.0, 3.0), (0.0, 1.0, 1.5, 1.5),
                      (0.0, 1.0, 0.5, 0.5)],
    "gamma_integral": [(0.0, 1.0, 1.0, 1.0), (0.5, 1.5, 1.0, 3.0)],
    "gamma_left_integral": [(1.0, 2.0, 2.0), (-1.0, 1.0, 1.0)],
    "gamma_right_integral": [(1.0, 1.0, 1.0)],
    "poisson_sum": [(5, 3, 2.0), (4, 4, 1.0), (2, 6, 1.0)],
    "binomial_sum": [(2, 4, 10, 0.3), (3, 3, 10, 0.5), (5, 1, 10, 0.5)],
}


@pytest.mark.parametrize("name", sorted(DIST_CASES))
def test_distributions_equal(name):
    """Each function on its grid, with the domain errors, Go's overflow
    results, the incomplete beta's symmetric branch and its NaN at
    a = b = 200, every INF spelling and tail branch of
    normal_adaptive_integral, a Romberg run that does not converge, and
    the quirks of poisson_sum (an empty range) and binomial_sum (the left
    term twice)."""
    for args in DIST_CASES[name]:
        assert _outcome(getattr(tdist, name), *args) == \
            _outcome(getattr(jdist, name), *args), args


def _windows(monkeypatch, name, calls):
    """Replaces each side's integrator ``name`` by one that records its
    limits and its integrand at five points, and returns their sum."""
    def record(f, start, end, *rest):
        xs = [start + (end - start) * i / 4 for i in range(5)]
        calls.append(_bits([start, end, *rest, [f(x) for x in xs]]))
        return start + end

    for mod in (tdist, jdist):
        monkeypatch.setattr(mod, name, record)


def test_normal_adaptive_integral_branches_equal(monkeypatch):
    """Every INF spelling, both tails' shortcuts and each tail's two
    integration windows: the window and the integrand at its points, the
    same on both sides (the integrals themselves are Romberg runs of
    seconds to minutes each; a short one is in DIST_CASES)."""
    cases = ([(lo, hi, 0.0, 1.0) for lo in INF_LEFT for hi in INF_RIGHT]
             + [(lo, "0.5", 0.0, 1.0) for lo in INF_LEFT]
             + [("-0.5", hi, 0.0, 1.0) for hi in INF_RIGHT]
             + [("-inf", r, 1.0, 2.0) for r in ("14", "-80", "-4", "-6.5")]
             + [(lo, "inf", 1.0, 2.0) for lo in ("-12", "80", "4", "22")]
             + [("0.2", "0.3", 5.0, 0.5), ("inf", "-inf", 0.0, 1.0)])
    seen = {}
    for side, mod in (("port", tdist), ("jax", jdist)):
        calls = []
        _windows(monkeypatch, "definite_small_integral", calls)
        seen[side] = ([_outcome(mod.normal_adaptive_integral, *c)
                       for c in cases], calls)
    assert seen["port"] == seen["jax"]
    assert len(seen["port"][1]) == 12


def test_integral_wrappers_equal(monkeypatch):
    """beta_, gamma_, gamma_left_ and gamma_right_integral hand
    definite_integral the same limits and integrand on both sides."""
    seen = {}
    for side, mod in (("port", tdist), ("jax", jdist)):
        calls = []
        _windows(monkeypatch, "definite_integral", calls)
        seen[side] = ([_outcome(mod.beta_integral, 0.1, 0.6, 2.0, 3.0),
                       _outcome(mod.gamma_integral, 0.5, 4.0, 2.0, 1.0),
                       _outcome(mod.gamma_left_integral, 3.0, 2.0, 1.5),
                       _outcome(mod.gamma_right_integral, 3.0, 2.0, 1.5)],
                      calls)
    assert seen["port"] == seen["jax"]


def test_distributions_quirks_pinned():
    assert tdist.poisson_sum(5, 3, 2.0) == 0
    assert tdist.binomial_sum(3, 3, 10, 0.5) == \
        2 * tdist.binomial_dist(10, 3, 0.5)
    assert math.isnan(tdist.regularized_incomplete_beta(200.0, 200.0, 0.3))
    assert tdist._go_gamma(200.0) == math.inf
    assert tdist._go_exp(710.0) == math.inf


def test_pearson_equal():
    rng = np.random.default_rng(5)
    x = rng.normal(size=200)
    y = 0.4 * x + rng.normal(size=200)
    assert _bits(tdist.pearson(x, y)) == _bits(jdist.pearson(x, y))
    assert _bits(tdist.pearson(list(x[:9]), list(y[:9]))) == \
        _bits(jdist.pearson(list(x[:9]), list(y[:9])))


@pytest.mark.parametrize("seed", [0, 9])
def test_fast_rejection_sampler_equal(seed):
    def f(x):
        return math.exp(-(x - 1.0) ** 2) + 0.1

    got = tdist.fast_rejection_sampler(-2.0, 4.0, f, 30, 100, 300,
                                       np.random.default_rng(seed))
    want = jdist.fast_rejection_sampler(-2.0, 4.0, f, 30, 100, 300,
                                        np.random.default_rng(seed))
    assert _bits(got) == _bits(want)

    def spikes(x):  # nonzero only at the bins' edges: every draw rejected
        return 1.0 if x in (0.0, 0.5, 1.0) else 0.0

    args = (0.0, 1.0, spikes, 2, 3, 4)
    assert _outcome(tdist.fast_rejection_sampler, *args,
                    rng=np.random.default_rng(seed)) == \
        _outcome(jdist.fast_rejection_sampler, *args,
                 rng=np.random.default_rng(seed))
    assert _outcome(tdist.fast_rejection_sampler, *args,
                    rng=np.random.default_rng(seed))[:2] == \
        ("raise", "ArithmeticError")


# --- gosamplers ---

SAMPLERS = {
    "rand_exp": lambda m, r: m.rand_exp(r),
    "rand_beta_small": lambda m, r: m.rand_beta(r, 0.5, 0.5),
    "rand_beta_large": lambda m, r: m.rand_beta(r, 2.0, 3.5),
    "rand_beta_mixed": lambda m, r: m.rand_beta(r, 0.3, 4.0),
    "rand_gamma_below_one": lambda m, r: m.rand_gamma(r, 0.5, 2.0),
    "rand_gamma_one": lambda m, r: m.rand_gamma(r, 1.0, 1.0),
    "rand_gamma_above_one": lambda m, r: m.rand_gamma(r, 3.0, 1.5),
    "rand_int_in_range": lambda m, r: m.rand_int_in_range(r, -5, 40),
    "rand_geometric": lambda m, r: m.rand_geometric(r, 0.3),
    "sample_inverse_normal": lambda m, r: m.sample_inverse_normal(r, 2.0,
                                                                  0.5),
    "rand_binomial": lambda m, r: m.rand_binomial(
        r, m.make_binomial_alias(20, 0.35)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("seed", [3, -11])
def test_sampler_draws_equal(name, seed):
    """1,000 draws, then the generators' states."""
    j, t = _pair(seed)
    draw = SAMPLERS[name]
    assert _bits([draw(tsamp, t) for _ in range(1000)]) == \
        _bits([draw(jsamp, j) for _ in range(1000)])
    assert _state(t) == _state(j)


@pytest.mark.parametrize("n", [1, 10, 100, 1000])
def test_make_binomial_alias_equal(n):
    for p in (1e-6, 0.01, 0.5, 0.99):
        got, want = tsamp.make_binomial_alias(n, p), \
            jsamp.make_binomial_alias(n, p)
        assert _bits(got.probability) == _bits(want.probability), p
        assert got.alias == want.alias, p


def test_sampler_errors_equal():
    """rand_gamma's domain error, rand_beta's exhaustion (a = 1,
    b = 1e-300 rejects every draw) and the generators' states after."""
    for args in ((-1.0, 1.0), (1.0, -2.0)):
        j, t = _pair(4)
        assert _outcome(tsamp.rand_gamma, t, *args) == \
            _outcome(jsamp.rand_gamma, j, *args)
    j, t = _pair(4)
    got = _outcome(tsamp.rand_beta, t, 1.0, 1e-300)
    assert got == _outcome(jsamp.rand_beta, j, 1.0, 1e-300)
    assert got[:2] == ("raise", "RuntimeError")
    assert _state(t) == _state(j)


def test_bounded_rejection_sample_equal():
    """Over scaled_beta_sampler: accepted draws; its Inf on overflow; an
    invalid bound and an exhausted loop, each a RuntimeError."""
    def target(x):
        return 3.0 * x * (1 - x) ** 2

    for mult, f, it in ((2.0, target, 50), (0.01, target, 50),
                        (2.0, lambda x: 0.0, 7)):
        j, t = _pair(12)
        js = jsamp.scaled_beta_sampler(j, 1.5, 2.5, mult)
        ts = tsamp.scaled_beta_sampler(t, 1.5, 2.5, mult)
        got = [_outcome(tsamp.bounded_rejection_sample, t, ts, f, 0.0, 1.0,
                        it) for _ in range(200 if f is target else 1)]
        want = [_outcome(jsamp.bounded_rejection_sample, j, js, f, 0.0, 1.0,
                         it) for _ in range(200 if f is target else 1)]
        assert got == want
        assert _state(t) == _state(j)
    assert got[0][:2] == ("raise", "RuntimeError")
    j, t = _pair(2)
    js = jsamp.scaled_beta_sampler(j, 0.5, 0.5, 1.0)
    ts = tsamp.scaled_beta_sampler(t, 0.5, 0.5, 1.0)
    draws = [ts() for _ in range(500)]
    assert _bits(draws) == _bits([js() for _ in range(500)])


# --- fit ---

@pytest.mark.parametrize("r,p", [(1.0, 0.4), (2, 0.1), (2, 0.4), (6, 0.4)])
def test_ztnb_equal(r, p):
    """tests/test_fit_hic.py's four NB histograms."""
    data = np.bincount(np.random.default_rng(0).negative_binomial(
        r, p, size=10000)).tolist()
    got = tfit.zero_truncated_negative_binomial(data, 5.0, 0.5, 0.1, 0.01)
    assert _bits(got) == _bits(jfit.zero_truncated_negative_binomial(
        data, 5.0, 0.5, 0.1, 0.01))


def test_ztnb_errors_and_barriers_equal():
    for args in (([0, 3, 1], 0.0, 0.5, 0.1, 0.01),
                 ([0, 3, 1], 1.0, 1.0, 0.1, 0.01),
                 ([0, 3, 1], 1.0, 0.0, 0.1, 0.01)):
        assert _outcome(tfit.zero_truncated_negative_binomial, *args) == \
            _outcome(jfit.zero_truncated_negative_binomial, *args)
    for d in range(9):
        for r, p in ((0.05, 0.995), (0.0005, 0.5), (2.0, 0.0005),
                     (0.0005, 0.0005), (1.0, 0.5)):
            assert _outcome(tfit._move, r, p, 0.1, 0.01, d) == \
                _outcome(jfit._move, r, p, 0.1, 0.01, d), (d, r, p)


def _mixture_data(seed: int, n: int) -> list[float]:
    rng = tgr.GoRand(seed)
    return [rng.norm_float64() * 0.8 if i % 3 else
            6.0 + rng.norm_float64() * 1.5 for i in range(n)]


def _run_mixture(mod, gr, data, k, iters, resets, eps, seed):
    mm = mod.MixtureModel()
    rng = gr.GoRand(seed) if seed is not None else None
    res = _outcome(mod.run_mixture_model_1d, data, k, iters, resets, eps,
                   mm, rng)
    return (res, _bits([mm.means, mm.stdev, mm.weights, mm.log_likelihood,
                        mm.k, mm.max_iter]),
            None if rng is None else _state(rng))


@pytest.mark.parametrize("case", [
    (300, 2, 100, 5, 1e-6),   # converges on the first start
    (300, 2, 3, 4, 1e-12),    # every start cut at 3 iterations: 4 resets
    (60, 3, 50, 3, 0.0),      # eps 0 means 1e-8; degenerate starts reset
    (0, 2, 10, 2, 1e-6),      # no data
    (2, 3, 10, 2, 1e-6),      # more gaussians than points
])
def test_run_mixture_model_1d_equal(case):
    n, k, iters, resets, eps = case
    data = _mixture_data(21, n)
    got = _run_mixture(tfit, tgr, data, k, iters, resets, eps, 8)
    assert got == _run_mixture(jfit, jgr, data, k, iters, resets, eps, 8)


def test_run_mixture_model_1d_default_rng_equal():
    """rng=None draws from each package's own default generator, seeded
    on both sides first."""
    data = _mixture_data(4, 200)
    tgr.seed(77)
    jgr.seed(77)
    got = _run_mixture(tfit, tgr, data, 2, 100, 5, 1e-6, None)
    assert got == _run_mixture(jfit, jgr, data, 2, 100, 5, 1e-6, None)
    assert _state(tgr.default()) == _state(jgr.default())
