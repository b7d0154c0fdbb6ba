"""The port's popgen (gonomics_tpu_torch/popgen.py, on the CPU) against
the JAX package.

The host functions, with the Dunn index's ``align/multi.py`` and
``align/oracle.py``, take the same inputs, built here from a numpy seed,
on both sides, and must agree bit for bit: floats by their 64 bits,
exceptions by type and message, MCMC traces by their bytes and the Go
generators by their state after the draws.

The device functions: ``afs_sample_density_grid`` on (n, k, alpha)
triples built here from a numpy seed, and ``wright_fisher_sim``, which
cannot replay ``jax.random`` and is held to the JAX test's statistical
checks.

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
import struct

import numpy as np
import pytest
import torch
from scipy.special import gammaln

from gonomics_tpu import dna as jdna
from gonomics_tpu import popgen as jpopgen
from gonomics_tpu.align import DEFAULT as JDEFAULT
from gonomics_tpu.align import multi as jmulti
from gonomics_tpu.align import oracle as joracle
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu_torch import dna as tdna
from gonomics_tpu_torch import popgen
from gonomics_tpu_torch.align import DEFAULT
from gonomics_tpu_torch.align import multi as tmulti
from gonomics_tpu_torch.align import oracle as toracle
from gonomics_tpu_torch.io import bed as tbed
from gonomics_tpu_torch.io import fasta as tfasta
from gonomics_tpu_torch.numbers import gorand as tgr

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



# --- the host functions, bit for bit ---

def _bits(x):
    """x with every float as its 64 bits (NaN as one token), recursively,
    dataclasses by their fields, so that == is bit-for-bit equality."""
    if isinstance(x, (float, np.floating)):
        return "nan" if math.isnan(x) else struct.pack("<d", float(x))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, _bits(x.tolist()))
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_bits(v) for v in x]
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return type(x).__name__, _bits(dict(vars(x)))
    return type(x).__name__, x


def _outcome(fn, *args, **kw):
    """fn's value as _bits, or the type and message of what it raised."""
    try:
        return "ok", _bits(fn(*args, **kw))
    except BaseException as e:  # SystemExit included
        return "raise", type(e).__name__, str(e)


def _both(name, *args, **kw):
    """(JAX, port) outcomes of popgen.<name>(*args, **kw)."""
    return (_outcome(getattr(jpopgen, name), *args, **kw),
            _outcome(getattr(popgen, name), *args, **kw))


def _afs(mod, sites):
    return mod.Afs([mod.SegSite(i, n, l) for i, n, l in sites])


def _sites(seed: int, count: int, ns=(6, 8, 11)):
    """Segregating sites (i, n, l) with l the ascertainment label."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.choice(ns))
        out.append((int(rng.integers(1, n)), n, int(rng.integers(0, 3))))
    return out


def test_constants_and_stationarity():
    assert _bits(popgen.PHI) == _bits(jpopgen.PHI)
    assert popgen.NEG_INF == jpopgen.NEG_INF == float("-inf")
    assert (popgen.UNCORRECTED, popgen.ANCESTRAL, popgen.DERIVED) == \
        (jpopgen.UNCORRECTED, jpopgen.ANCESTRAL, jpopgen.DERIVED)
    rng = np.random.default_rng(30)
    ps = list(rng.uniform(1e-6, 1 - 1e-6, 200)) + [1e-12, 0.5, 1 - 1e-12]
    alphas = list(rng.uniform(-25, 25, 200)) + [-1e-9, 1e-9, 700.0]
    for p, a in zip(ps, alphas):
        want, got = _both("afs_stationarity", float(p), float(a))
        assert got == want
    assert _both("afs_stationarity", 0.3, 0.0)[0][0] == "raise"
    want, got = _both("afs_stationarity", 0.3, 0.0)
    assert got == want


@pytest.mark.parametrize("n,err", [(2, 1e-7), (6, 1e-7), (11, 1e-5),
                                   (20, 1e-6)])
def test_densities_and_probabilities(n, err):
    """build_binom_cache, afs_sample_density (each k) and
    allele_frequency_probability (each i) at alphas of both signs."""
    jc, tc = jpopgen.build_binom_cache([n, 3]), popgen.build_binom_cache(
        [n, 3])
    assert _bits(tc) == _bits(jc)
    for alpha in (-7.3, -0.5, 0.01, 2.0, 9.9):
        for k in range(1, n):
            assert _outcome(popgen.afs_sample_density, n, k, alpha, tc,
                            err) == _outcome(jpopgen.afs_sample_density, n,
                                             k, alpha, jc, err)
            assert _outcome(popgen.allele_frequency_probability, k, n,
                            alpha, tc, err) == _outcome(
                jpopgen.allele_frequency_probability, k, n, alpha, jc, err)
    want = _outcome(jpopgen.afs_sample_density, n, 1, 0, jc)
    assert want[0] == "raise"
    assert _outcome(popgen.afs_sample_density, n, 1, 0, tc) == want


def test_adaptive_simpsons_log_depth():
    """The integral's literal recursion and its depth error."""
    def f(p):
        return math.log(p * p + 1e-300)
    for a, b, e, depth in ((0.0, 1.0, 1e-6, 100), (0.1, 0.9, 1e-12, 3),
                           (0.0, 0.5, 1e-9, 0)):
        assert _outcome(popgen.adaptive_simpsons_log, f, a, b, e, depth) \
            == _outcome(jpopgen.adaptive_simpsons_log, f, a, b, e, depth)
    assert _outcome(popgen.adaptive_simpsons_log, f, 0.1, 0.9, 1e-12,
                    3)[0] == "raise"


@pytest.mark.parametrize("n,alpha", [(5, -3.0), (12, 1.5), (9, 0.2)])
def test_ascertainment_family(n, alpha):
    err = 1e-6
    jc, tc = jpopgen.build_binom_cache([n]), popgen.build_binom_cache([n])
    jf = jpopgen.build_f_cache(n, alpha, jc, err)
    tf = popgen.build_f_cache(n, alpha, tc, err)
    assert _bits(tf) == _bits(jf)
    assert _bits(popgen.get_f_cache_sum(tf)) == \
        _bits(jpopgen.get_f_cache_sum(jf))
    s = jpopgen.get_f_cache_sum(jf)
    for d in (1, 2, 3):
        for name in ("ancestral_ascertainment_denominator",
                     "derived_ascertainment_denominator"):
            want, got = _both(name, jf, s, d)
            assert got == want
        for i in range(1, n):
            for name in ("ancestral_ascertainment_probability",
                         "derived_ascertainment_probability"):
                want, got = _both(name, n, i, d)
                assert got == want
            for name in (
                    "allele_frequency_probability_ancestral_ascertainment",
                    "allele_frequency_probability_derived_ascertainment"):
                assert _outcome(getattr(popgen, name), alpha, i, n, d, tc,
                                err) == _outcome(getattr(jpopgen, name),
                                                 alpha, i, n, d, jc, err)


@pytest.mark.parametrize("seed", [31, 32])
def test_likelihoods(seed):
    """The fixed-alpha likelihoods (plain and ascertained) and the
    per-site-alpha ones, on seeded sites with every label."""
    sites = _sites(seed, 14)
    ja, ta = _afs(jpopgen, sites), _afs(popgen, sites)
    rng = np.random.default_rng(seed + 100)
    alphas = [float(a) for a in rng.normal(0.5, 2.0, len(sites))]
    err = 1e-5
    for alpha in (-4.0, 0.75, 6.0):
        assert _outcome(popgen.afs_likelihood_fixed_alpha, ta, alpha,
                        err) == _outcome(jpopgen.afs_likelihood_fixed_alpha,
                                         ja, alpha, err)
        for d in (1, 2):
            assert _outcome(popgen.afs_divergence_ascertainment_fixed_alpha,
                            ta, alpha, d, err) == _outcome(
                jpopgen.afs_divergence_ascertainment_fixed_alpha, ja, alpha,
                d, err)
    all_n = sorted({n for _, n, _ in sites})
    jc, tc = jpopgen.build_binom_cache(all_n), popgen.build_binom_cache(all_n)
    assert _outcome(popgen.afs_likelihood, ta, alphas, tc, err) == \
        _outcome(jpopgen.afs_likelihood, ja, alphas, jc, err)
    for d in (1, 2):
        assert _outcome(popgen.afs_divergence_ascertainment_likelihood, ta,
                        alphas, tc, d, err) == _outcome(
            jpopgen.afs_divergence_ascertainment_likelihood, ja, alphas, jc,
            d, err)


def test_golden_section_and_mle():
    for f in (lambda x: -(x - 1.3) ** 2, lambda x: math.sin(x),
              lambda x: -abs(x + 7.25)):
        for a, b, e in ((-10, 10, 1e-5), (10, -10, 1e-3), (0.0, 2.0, 0.5)):
            want, got = _both("golden_section_max_search", f, a, b, e)
            assert got == want
    sites = _sites(33, 10)
    ja, ta = _afs(jpopgen, sites), _afs(popgen, sites)
    assert _outcome(popgen.selection_mle, ta, -5, 5, 1e-3, 1e-4) == \
        _outcome(jpopgen.selection_mle, ja, -5, 5, 1e-3, 1e-4)
    for div, d in ((False, 1), (True, 1), (True, 2)):
        kw = dict(left=-6.0, right=8.0, error=1e-3, integral_error=1e-4,
                  divergence_ascertainment=div, d=d)
        assert _outcome(popgen.selection_maximum_likelihood_estimate, ta,
                        **kw) == _outcome(
            jpopgen.selection_maximum_likelihood_estimate, ja, **kw)


def popgen_vcf(path, seed: int, sites: int = 40, samples: int = 5,
               bad: str = "") -> None:
    """A VCF of biallelic SNPs over diploid samples: phased and unphased
    genotypes, a missing call and a half call now and then, AA on REF,
    on ALT (either case), on neither and absent, and a symbolic ALT,
    each site segregating among its full calls. bad adds a last site
    with no calls ("nodata") or none ALT ("mono")."""
    rng = np.random.default_rng(seed)
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
            "\tINFO\tFORMAT\t" + "\t".join(f"S{j}" for j in range(samples))
            + "\n")
    rows = []
    for s in range(sites):
        ref, alt = rng.choice(list("ACGT"), 2, replace=False)
        while True:
            gts, full = [], []
            for _ in range(samples):
                r = rng.random()
                a, b = (int(x) for x in rng.integers(0, 2, 2))
                if r < 0.06:
                    gts.append("./.")
                elif r < 0.1:
                    gts.append(f"{a}/.")
                else:
                    gts.append(f"{a}{'|' if r < 0.6 else '/'}{b}")
                    full += [a, b]
            if 0 < sum(full) < len(full):
                break
        kind = rng.random()
        info = ("DP=9" if kind < 0.15 else
                f"DP=3;AA={alt.lower() if kind < 0.3 else alt}"
                if kind < 0.45 else
                f"AA={'N' if kind < 0.55 else ref}" if kind < 0.9 else ".")
        alt_f = "<DEL>" if rng.random() < 0.05 else str(alt)
        rows.append(f"chr1\t{s + 1}\t.\t{ref}\t{alt_f}\t50\tPASS\t{info}"
                    f"\tGT\t" + "\t".join(gts))
    if bad == "nodata":
        rows.append("chr1\t999\t.\tA\tC\t50\tPASS\tAA=A\tGT\t"
                    + "\t".join(["./."] * samples))
    elif bad == "mono":
        rows.append("chr1\t999\t.\tA\tC\t50\tPASS\tAA=A\tGT\t"
                    + "\t".join(["0|0"] * samples))
    with open(path, "w") as f:
        f.write(head + "\n".join(rows) + "\n")


def _sites_of(afs):
    return [(s.i, s.n, s.l) for s in afs.sites]


@pytest.mark.parametrize("unpolarized", [False, True])
@pytest.mark.parametrize("divergence", [False, True])
@pytest.mark.parametrize("include_ref", [False, True])
def test_vcf_to_afs(tmp_path, unpolarized, divergence, include_ref):
    path = str(tmp_path / "p.vcf")
    popgen_vcf(path, 34)
    kw = dict(unpolarized=unpolarized, divergence_ascertainment=divergence,
              include_ref=include_ref)
    want = jpopgen.vcf_to_afs(path, **kw)
    got = popgen.vcf_to_afs(path, **kw)
    assert type(got) is popgen.Afs
    assert _sites_of(got) == _sites_of(want)
    assert 0 < len(got.sites) < 40      # the symbolic ALT is skipped


@pytest.mark.parametrize("bad", ["nodata", "mono"])
def test_vcf_to_afs_errors(tmp_path, bad):
    path = str(tmp_path / "bad.vcf")
    popgen_vcf(path, 35, sites=6, bad=bad)
    want = _outcome(jpopgen.vcf_to_afs, path)
    assert want[0] == "raise"
    assert _outcome(popgen.vcf_to_afs, path) == want


GROUPS = ">ingroup\nh1\nh2\nh3\n>outgroup\nc1\nc2\nabsent\n"


def _aln(seed: int, length: int = 120):
    """Six related rows (names of GROUPS' members and one stray) as FASTA
    text with gaps, lower case and an N, the first the reference."""
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), length)
    rows = {}
    for k, name in enumerate(["h1", "h2", "h3", "c1", "c2", "stray"]):
        row = base.copy()
        flip = rng.random(length) < (0.04 if k < 3 else 0.12)
        row[flip] = rng.choice(list("ACGT"), int(flip.sum()))
        if k:
            for start in rng.integers(0, length - 6, 2):
                row[start:start + int(rng.integers(1, 5))] = "-"
        if k == 2:
            row[10:14] = [c.lower() for c in row[10:14]]
            row[50] = "N"
        rows[name] = "".join(row)
    return "".join(f">{n}\n{s}\n" for n, s in rows.items())


def test_read_groups_and_filters(tmp_path):
    g = tmp_path / "groups.list"
    g.write_text(GROUPS)
    jg, tg = jpopgen.read_groups(str(g)), popgen.read_groups(str(g))
    assert [(x.name, x.members) for x in tg] == \
        [(x.name, x.members) for x in jg] == \
        [("ingroup", ["h1", "h2", "h3"]), ("outgroup", ["c1", "c2",
                                                        "absent"])]
    a = tmp_path / "a.fa"
    a.write_text(_aln(36))
    ja, ta = jfasta.read(str(a)), tfasta.read(str(a))
    assert [r.name for r in popgen.filter_mult_by_group(ta, tg)] == \
        [r.name for r in jpopgen.filter_mult_by_group(ja, jg)]
    assert popgen.find_missing_group_members(ta, tg) == \
        jpopgen.find_missing_group_members(ja, jg) == \
        "Missing: ingroup: outgroup: absent, "


@pytest.mark.parametrize("realign", [False, True])
@pytest.mark.parametrize("seed", [37, 38])
def test_dunn(tmp_path, realign, seed):
    g = tmp_path / "groups.list"
    g.write_text(GROUPS)
    a = tmp_path / "a.fa"
    a.write_text(_aln(seed))
    ja, ta = jfasta.read(str(a)), tfasta.read(str(a))
    jg, tg = jpopgen.read_groups(str(g)), popgen.read_groups(str(g))
    for start, end in ((0, 40), (5, 90), (30, 100), (0, 100)):
        jb = jbed.Bed("chr1", start, end)
        tb = tbed.Bed("chr1", start, end)
        want = _outcome(jpopgen.dunn, jb, ja, jg, realign)
        assert _outcome(popgen.dunn, tb, ta, tg, realign) == want
        assert want[0] == "ok"
    # the inputs are left as the JAX leaves them
    assert _bits([r.seq for r in ta]) == _bits([r.seq for r in ja])


def test_dunn_helpers(tmp_path):
    """dna.dist and io/fasta.py's copy_subset, remove_missing_mult,
    dist_column and num_segregating_sites."""
    a = tmp_path / "a.fa"
    a.write_text(_aln(39) + ">empty\n" + "-" * 120 + "\n")
    ja, ta = jfasta.read(str(a)), tfasta.read(str(a))
    for start, end in ((0, 120), (7, 61), (60, 60)):
        js, ts = jfasta.copy_subset(ja, start, end), tfasta.copy_subset(
            ta, start, end)
        assert _bits([(r.name, r.seq) for r in ts]) == \
            _bits([(r.name, r.seq) for r in js])
        jm, tm = jfasta.remove_missing_mult(js), tfasta.remove_missing_mult(
            ts)
        assert [r.name for r in tm] == [r.name for r in jm]
        if not tm:
            continue
        jd, td = jfasta.dist_column(jm), tfasta.dist_column(tm)
        assert _bits([(r.name, r.seq) for r in td]) == \
            _bits([(r.name, r.seq) for r in jd])
        assert tfasta.num_segregating_sites(td) == \
            jfasta.num_segregating_sites(jd)
        for x in td:
            for y in td:
                assert tdna.dist(x.seq, y.seq) == jdna.dist(x.seq, y.seq)
    assert _outcome(tdna.dist, ta[0].seq, ta[0].seq[:5]) == \
        _outcome(jdna.dist, ja[0].seq, ja[0].seq[:5])


def test_affine_gap_from_sub():
    rng = np.random.default_rng(40)
    for n, m in ((1, 1), (1, 7), (6, 1), (9, 13), (30, 24)):
        sub = rng.integers(-150, 120, (n, m)).astype(np.int64)
        for go, ge in ((-400, -30), (-10, -1), (0, 0)):
            want = joracle.affine_gap_from_sub(sub, go, ge)
            got = toracle.affine_gap_from_sub(sub, go, ge)
            assert got[0] == want[0]
            assert [(c.run_length, c.op) for c in got[1]] == \
                [(c.run_length, c.op) for c in want[1]]


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_all_seq_affine(seed):
    """Progressive alignment of 2-5 gap-free rows of unequal lengths,
    lower case and N among them, and its pair score matrices."""
    rng = np.random.default_rng(seed)
    count = int(rng.integers(2, 6))
    base = rng.integers(0, 4, 40)
    texts = []
    for _ in range(count):
        row = base[rng.random(40) > 0.15].copy()
        row[rng.random(len(row)) < 0.1] = rng.integers(0, 4)
        texts.append("".join("ACGT"[b] for b in row))
    texts[-1] = texts[-1][:5].lower() + texts[-1][5:-1] + "N"
    jrec = [jfasta.Fasta(f"r{k}", jdna.from_string(t))
            for k, t in enumerate(texts)]
    trec = [tfasta.Fasta(f"r{k}", tdna.from_string(t))
            for k, t in enumerate(texts)]
    assert _bits(tmulti._pair_sub_matrix(trec[:1], trec[-1:], DEFAULT)) == \
        _bits(jmulti._pair_sub_matrix(jrec[:1], jrec[-1:], JDEFAULT))
    want = jmulti.all_seq_affine(jrec, JDEFAULT, -400, -30)
    got = tmulti.all_seq_affine(trec, DEFAULT, -400, -30)
    assert _bits([(r.name, r.seq) for r in got]) == \
        _bits([(r.name, r.seq) for r in want])
    assert len({len(r.seq) for r in got}) == 1


def _trace_run(mod, gr, tmp_path, sites, s_kw, rng_of, tag):
    out = str(tmp_path / f"{tag}.trace")
    rng = rng_of(gr)
    res = _outcome(mod.metropolis_hastings, _afs(mod, sites), out,
                   mod.McmcSettings(**s_kw), rng)
    try:
        with open(out, "rb") as f:
            text = f.read()
    except FileNotFoundError:
        text = None
    state = ((list(rng._v), rng.tap, rng.feed) if hasattr(rng, "tap")
             else rng.bit_generator.state)
    return res, text, state


@pytest.mark.parametrize("case", [
    ("go", 7, {}),
    ("go", -1, {"fixed_sigma": True, "mu_zero": 1.0}),
    ("go", 2**31, {"divergence_ascertainment": True, "sigma_zero": 0.5}),
    ("numpy", 11, {"sigma_step": 0.5}),
    ("go", 3, {"sigma_zero": -1.0}),        # the overdispersed start
])
def test_metropolis_hastings(tmp_path, case):
    """Trace bytes and the generator after the draws, from a GoRand and
    from a numpy Generator (10 sites, n <= 10, 12 iterations)."""
    kind, seed, extra = case
    sites = _sites(44, 10, ns=(6, 8, 10))
    s_kw = dict(iterations=12, integral_error=1e-5, **extra)
    if kind == "go":
        pairs = [(jpopgen, jgr.GoRand), (popgen, tgr.GoRand)]
    else:
        pairs = [(jpopgen, np.random.default_rng),
                 (popgen, np.random.default_rng)]
    want, got = (_trace_run(mod, gr, tmp_path, sites, s_kw,
                            lambda g: g(seed), tag)
                 for (mod, gr), tag in zip(pairs, ("jax", "port")))
    assert got == want
    if "sigma_zero" in extra and extra["sigma_zero"] < 0:
        assert want[0][0] == "raise"
    else:
        lines = want[1].decode().splitlines()
        assert lines[0] == "Iteration\tMu\tSigma\tAccept"
        assert len(lines) == 13


def test_prior_prob():
    for mu, sigma in ((0.0, 1.0), (2.5, 0.01), (-1.0, -0.1), (40.0, 3.0),
                      (0.0, 0.0)):
        for kw in ({}, {"sigma_prior_alpha": 1.0, "mu_prior_sigma": 0.5}):
            assert _outcome(popgen._prior_prob, mu, sigma,
                            popgen.McmcSettings(**kw)) == _outcome(
                jpopgen._prior_prob, mu, sigma, jpopgen.McmcSettings(**kw))
