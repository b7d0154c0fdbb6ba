"""Population genetics: the allele-frequency-spectrum machinery, a copy
of ``gonomics_tpu/popgen.py`` (627 lines), now whole.

The host code keeps the JAX's float64 steps in their order, so every
value is the JAX's to the bit: ``PHI``, ``NEG_INF``, ``SegSite`` and
``Afs`` (:23-37); the stationary density, the log-space adaptive Simpson
integral and the sample densities, probabilities and fixed-alpha
likelihood with its per-n denominator cache (:39-165); the divergence
ascertainment family (:166-292); ``vcf_to_afs`` (:295-340) on the
port's ``io/vcf.read``; the golden-section search and ``selection_mle``
(:343-369); the groups and the Dunn index (:424-500), whose ``-realign``
path runs ``align/multi.all_seq_affine``'s numpy DP; the Metropolis-
Hastings sampler, which draws from a ``GoRand`` or a numpy
``Generator`` (:503-605); and ``selection_maximum_likelihood_estimate``
(:608-627).

The two device functions, ``afs_sample_density_grid`` (:375) and
``wright_fisher_sim`` (:405), run on ``device`` (None: the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import resolve_device
from .numbers import binom_coefficient_log, binomial_expression_log
from .numbers import logspace

PHI = (1 + math.sqrt(5)) / 2
NEG_INF = float("-inf")


@dataclass
class SegSite:
    i: int
    n: int
    l: int = 0


@dataclass
class Afs:
    sites: list[SegSite] = field(default_factory=list)


def afs_stationarity(p: float, alpha: float) -> float:
    """AfsStationarity (stationarity.go:174)."""
    return (1 - math.exp(-alpha * (1 - p))) * 2 / \
        ((1 - math.exp(-alpha)) * p * (1 - p))


def build_binom_cache(all_n: list[int]) -> dict[int, list[float]]:
    out: dict[int, list[float]] = {}
    for n in all_n:
        out[n] = [0.0] * n
        for k in range(1, n):
            out[n][k] = binom_coefficient_log(n, k)
    return out


def _f_integrand(n: int, k: int, alpha: float, binom_coeff: float):
    def f(p: float) -> float:
        expr = binomial_expression_log(n - 2, k - 1, p)
        log_part = logspace.go_log((1 - math.exp(-alpha * (1.0 - p))) * 2
                                   / (1 - math.exp(-alpha)))
        return logspace.multiply(binom_coeff,
                                 logspace.multiply(expr, log_part))
    return f


def adaptive_simpsons_log(f, a: float, b: float, error_threshold: float,
                          max_depth: int) -> float:
    """numbers.AdaptiveSimpsonsLog (integrate.go:209), literal recursion."""
    LOG4 = 1.386294  # the reference's rounded constants
    LOG15 = 2.70805  # (integrate.go:166-168)
    LOG_HALF = -0.6931472

    def helper(a, b, midpoint, fa, fb, fm, whole, err_thresh, depth):
        h = (b - a) / 2
        lm = (a + midpoint) / 2
        rm = (midpoint + b) / 2
        if depth < 0:
            raise ValueError("integration exceeded maximum depth")
        flm = f(lm)
        frm = f(rm)
        log_h6 = math.log(h / 6)
        left = logspace.multiply(log_h6, logspace.add(
            logspace.add(fa, logspace.multiply(LOG4, flm)), fm))
        right = logspace.multiply(log_h6, logspace.add(
            logspace.add(fm, logspace.multiply(LOG4, frm)), fb))
        halves = logspace.add(left, right)
        # exact-equality falls through to recursion (integrate.go:192-202)
        if halves > whole:
            delta = logspace.subtract(halves, whole)
            if delta <= logspace.multiply(LOG15, err_thresh):
                return logspace.add(logspace.add(left, right),
                                    logspace.divide(delta, LOG15))
        elif whole > halves:
            delta = logspace.subtract(whole, halves)
            if delta <= logspace.multiply(LOG15, err_thresh):
                return logspace.add(logspace.add(left, right),
                                    logspace.divide(delta, LOG15))
        half_err = logspace.multiply(err_thresh, LOG_HALF)
        return logspace.add(
            helper(a, midpoint, lm, fa, fm, flm, left, half_err, depth - 1),
            helper(midpoint, b, rm, fm, fb, frm, right, half_err, depth - 1))

    h = b - a
    midpoint = (a + b) / 2
    fa, fb, fm = f(a), f(b), f(midpoint)
    s = logspace.multiply(math.log(h / 6), logspace.add(
        logspace.add(fa, logspace.multiply(LOG4, fm)), fb))
    return helper(a, b, midpoint, fa, fb, fm, s,
                  math.log(error_threshold), max_depth)


def afs_sample_density(n: int, k: int, alpha: float, binom_cache,
                       integral_error: float = 1e-7) -> float:
    """AfsSampleDensity / the F function (stationarity.go:196)."""
    if alpha == 0:
        raise ValueError("alpha cannot be exactly zero")
    switch = k / n
    f = _f_integrand(n, k, alpha, binom_cache[n][k])
    return logspace.add(
        adaptive_simpsons_log(f, 0.0, switch, integral_error, 100),
        adaptive_simpsons_log(f, switch, 1.0, integral_error, 100))


def allele_frequency_probability(i: int, n: int, alpha: float, binom_cache,
                                 integral_error: float = 1e-7) -> float:
    denom = NEG_INF
    for j in range(1, n):
        denom = logspace.add(denom, afs_sample_density(n, j, alpha,
                                                       binom_cache,
                                                       integral_error))
    return logspace.divide(
        afs_sample_density(n, i, alpha, binom_cache, integral_error), denom)


def afs_likelihood_fixed_alpha(afs: Afs, alpha: float,
                               integral_error: float = 1e-7) -> float:
    """AfsLikelihoodFixedAlpha (stationarity.go:227). The per-(n,i)
    probability cache matches the reference; the per-n denominator is
    additionally cached (the reference recomputes it — identical floats,
    just fewer redundant integrals)."""
    all_n = sorted({s.n for s in afs.sites})
    binom_cache = build_binom_cache(all_n)
    denom_cache: dict[int, float] = {}
    dens_cache: dict[tuple[int, int], float] = {}

    def density(n: int, k: int) -> float:
        if (n, k) not in dens_cache:
            dens_cache[(n, k)] = afs_sample_density(n, k, alpha, binom_cache,
                                                    integral_error)
        return dens_cache[(n, k)]

    cache: dict[tuple[int, int], float] = {}
    ans = 0.0
    for s in afs.sites:
        key = (s.n, s.i)
        if key not in cache:
            if s.n not in denom_cache:
                d = NEG_INF
                for j in range(1, s.n):
                    d = logspace.add(d, density(s.n, j))
                denom_cache[s.n] = d
            cache[key] = logspace.divide(density(s.n, s.i),
                                         denom_cache[s.n])
        ans = logspace.multiply(ans, cache[key])
    return ans


# --- divergence-based ascertainment corrections (popgen/ascertainment.go) ---

def build_f_cache(n: int, alpha: float, binom_cache,
                  integral_error: float) -> list[float]:
    """BuildFCache (ascertainment.go:12): log F(j | n, alpha) for j in 1..n-1."""
    out = [0.0] * n
    for j in range(1, n):
        out[j] = afs_sample_density(n, j, alpha, binom_cache, integral_error)
    return out


def get_f_cache_sum(f_cache: list[float]) -> float:
    """GetFCacheSum (ascertainment.go:21)."""
    ans = NEG_INF
    for j in range(1, len(f_cache)):
        ans = logspace.add(ans, f_cache[j])
    return ans


def ancestral_ascertainment_probability(n: int, i: int, d: int) -> float:
    """AncestralAscertainmentProbability (ascertainment.go:52)."""
    return logspace.divide(binom_coefficient_log(n - i, d),
                           binom_coefficient_log(n, d))


def derived_ascertainment_probability(n: int, i: int, d: int) -> float:
    """DerivedAscertainmentProbability (ascertainment.go:57)."""
    return logspace.divide(binom_coefficient_log(i, d),
                           binom_coefficient_log(n, d))


def ancestral_ascertainment_denominator(f_cache, f_cache_sum: float,
                                        d: int) -> float:
    """AncestralAscertainmentDenominator (ascertainment.go:30)."""
    ans = NEG_INF
    for j in range(1, len(f_cache)):
        ans = logspace.add(ans, logspace.multiply(
            logspace.divide(f_cache[j], f_cache_sum),
            ancestral_ascertainment_probability(len(f_cache), j, d)))
    return ans


def derived_ascertainment_denominator(f_cache, f_cache_sum: float,
                                      d: int) -> float:
    """DerivedAscertainmentDenominator (ascertainment.go:41)."""
    ans = NEG_INF
    for j in range(1, len(f_cache)):
        ans = logspace.add(ans, logspace.multiply(
            logspace.divide(f_cache[j], f_cache_sum),
            derived_ascertainment_probability(len(f_cache), j, d)))
    return ans


def allele_frequency_probability_ancestral_ascertainment(
        alpha: float, i: int, n: int, d: int, binom_cache,
        integral_error: float = 1e-7) -> float:
    """AlleleFrequencyProbabilityAncestralAscertainment (ascertainment.go:62)."""
    f_cache = build_f_cache(n, alpha, binom_cache, integral_error)
    f_sum = get_f_cache_sum(f_cache)
    p_i = logspace.divide(f_cache[i], f_sum)
    return logspace.divide(
        logspace.multiply(p_i, ancestral_ascertainment_probability(n, i, d)),
        ancestral_ascertainment_denominator(f_cache, f_sum, d))


def allele_frequency_probability_derived_ascertainment(
        alpha: float, i: int, n: int, d: int, binom_cache,
        integral_error: float = 1e-7) -> float:
    """AlleleFrequencyProbabilityDerivedAscertainment (ascertainment.go:71)."""
    f_cache = build_f_cache(n, alpha, binom_cache, integral_error)
    f_sum = get_f_cache_sum(f_cache)
    p_i = logspace.divide(f_cache[i], f_sum)
    return logspace.divide(
        logspace.multiply(p_i, derived_ascertainment_probability(n, i, d)),
        derived_ascertainment_denominator(f_cache, f_sum, d))


# SegSite.l values (popgen.LikelihoodFunction: stationarity.go)
UNCORRECTED, ANCESTRAL, DERIVED = 0, 1, 2


def afs_divergence_ascertainment_fixed_alpha(
        afs: Afs, alpha: float, d: int = 1,
        integral_error: float = 1e-7) -> float:
    """AfsDivergenceAscertainmentFixedAlpha (ascertainment.go:100): fixed-
    alpha likelihood with per-site divergence ascertainment corrections."""
    all_n = sorted({s.n for s in afs.sites})
    binom_cache = build_binom_cache(all_n)
    caches = {UNCORRECTED: {}, ANCESTRAL: {}, DERIVED: {}}
    ans = 0.0
    for s in afs.sites:
        cache = caches[s.l]
        key = (s.n, s.i)
        if key not in cache:
            if s.l == UNCORRECTED:
                cache[key] = allele_frequency_probability(
                    s.i, s.n, alpha, binom_cache, integral_error)
            elif s.l == ANCESTRAL:
                cache[key] = \
                    allele_frequency_probability_ancestral_ascertainment(
                        alpha, s.i, s.n, d, binom_cache, integral_error)
            else:
                cache[key] = \
                    allele_frequency_probability_derived_ascertainment(
                        alpha, s.i, s.n, d, binom_cache, integral_error)
        ans = logspace.multiply(ans, cache[key])
    return ans


def afs_divergence_ascertainment_likelihood(
        afs: Afs, alphas, binom_cache, d: int,
        integral_error: float) -> float:
    """AfsDivergenceAscertainmentLikelihood (ascertainment.go:81):
    per-site alphas with ascertainment corrections."""
    ans = 0.0
    for s, alpha in zip(afs.sites, alphas):
        if s.l == ANCESTRAL:
            cur = allele_frequency_probability_ancestral_ascertainment(
                alpha, s.i, s.n, d, binom_cache, integral_error)
        elif s.l == DERIVED:
            cur = allele_frequency_probability_derived_ascertainment(
                alpha, s.i, s.n, d, binom_cache, integral_error)
        else:
            cur = allele_frequency_probability(
                s.i, s.n, alpha, binom_cache, integral_error)
        ans = logspace.multiply(ans, cur)
    return ans


def vcf_to_afs(filename: str, unpolarized: bool = False,
               divergence_ascertainment: bool = False,
               include_ref: bool = False) -> Afs:
    """popgen.VcfToAfs (stationarity.go:86)."""
    from .io import vcf as vcfio

    records, _ = vcfio.read(filename)
    afs = Afs()
    for v in records:
        if "<" in v.alt[0] or ">" in v.alt[0]:
            continue
        seg = SegSite(0, 0, 0)
        for s in v.samples:
            if (s.alleles is not None and len(s.alleles) == 2
                    and -1 not in s.alleles):
                seg.n += 2
                seg.i += sum(1 for a in s.alleles if a > 0)
        has_aa = "AA=" in v.info
        aa = ""
        if has_aa:
            for fld in v.info.split(";"):
                if fld.startswith("AA="):
                    aa = fld[3:].upper()
        if include_ref:
            if has_aa and aa == v.alt[0].upper():
                seg.i += 1
            seg.n += 1
        if seg.n == 0:
            raise ValueError("variant had no sample data")
        if seg.i == 0 or seg.i == seg.n:
            raise ValueError("variant is nonsegregating")
        if not unpolarized and has_aa:
            # sites without AA annotations pass through unpolarized,
            # like VcfSampleToSegSite (stationarity.go:134)
            is_ref_anc = aa == v.ref.upper()
            is_alt_anc = aa == v.alt[0].upper()
            if is_ref_anc and divergence_ascertainment:
                seg.l = 1
            if is_alt_anc:
                seg.i = seg.n - seg.i
                if divergence_ascertainment:
                    seg.l = 2
            elif not is_ref_anc:
                continue
        afs.sites.append(seg)
    return afs


def golden_section_max_search(f, a: float, b: float,
                              epsilon: float) -> float:
    """numbers.GoldenSectionMaxSearch (search.go:9)."""
    a, b = min(a, b), max(a, b)
    c = b + (a - b) / PHI
    d = a + (b - a) / PHI
    fc, fd = f(c), f(d)
    while abs(b - a) > epsilon:
        if fc < fd:
            a, c, fc = c, d, fd
            d = a + (b - a) / PHI
            fd = f(d)
        else:
            b, d, fd = d, c, fc
            c = b + (a - b) / PHI
            fc = f(c)
    return (a + b) / 2.0


def selection_mle(data: Afs, left: float = -10, right: float = 10,
                  error: float = 1e-5,
                  integral_error: float = 1e-7) -> float:
    """SelectionMaximumLikelihoodEstimate (maximumLikelihood.go:21)."""
    return golden_section_max_search(
        lambda a: afs_likelihood_fixed_alpha(data, a, integral_error),
        left, right, error)


def afs_sample_density_grid(n, k, alpha, grid_points: int = 2049,
                            device=None) -> torch.Tensor:
    """The log F function (the selection-weighted allele-frequency
    integral of AfsSampleDensity) of each (n, k, alpha) on ``device``
    (None: the card): a composite Simpson sum over ``grid_points`` points
    of p in [1e-9, 1 - 1e-9], in log space, as a float32 tensor.

    float32 whatever the input, as the JAX function, whose float64 branch
    (popgen.py:383-384) is overwritten on :385. So 1 - 1e-9 rounds to 1.0,
    the last point's log1p(-p) is -inf, and where k = n - 1 its term is
    0 * -inf: the result is NaN there, as the JAX's is."""
    dev = resolve_device(device)
    f32 = torch.float32
    n, k, alpha = (torch.as_tensor(np.asarray(x)).to(dev, f32)
                   for x in (n, k, alpha))
    p = torch.linspace(1e-9, 1 - 1e-9, grid_points, dtype=f32, device=dev)
    log_binom = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                 - torch.lgamma(n - k + 1))
    lp = torch.log(p)[None, :]
    l1p = torch.log1p(-p)[None, :]
    expr = (k[:, None] - 1) * lp + (n[:, None] - k[:, None] - 1) * l1p
    sel = torch.log((1 - torch.exp(-alpha[:, None] * (1 - p[None, :]))) * 2
                    / (1 - torch.exp(-alpha[:, None])))
    log_f = log_binom[:, None] + expr + sel
    w = torch.ones(grid_points, dtype=f32, device=dev)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    h = (p[-1] - p[0]) / (grid_points - 1)
    m = torch.amax(log_f, dim=1, keepdim=True)
    integral = torch.sum(w[None, :] * torch.exp(log_f - m), dim=1) * h / 3
    return m[:, 0] + torch.log(integral)


def wright_fisher_sim(pop_size: int, generations: int, s: float = 0.0,
                      init_freq: float = 0.5, seed: int = 0,
                      device=None) -> torch.Tensor:
    """A forward Wright-Fisher allele-frequency trajectory, (generations,)
    float32 on ``device`` (None: the card): each generation draws
    Binomial(pop_size, p) with p the selection-weighted frequency
    freq (1 + s) / (freq (1 + s) + 1 - freq), and the next frequency is
    draws / pop_size. The draws come from a ``torch.Generator`` on the
    device seeded with ``seed``, so a seed gives the same trajectory on
    one device; they cannot replay the JAX function's ``jax.random``
    stream, so the two agree in distribution, not draw for draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    count = torch.full((1,), float(pop_size), dtype=torch.float32,
                       device=dev)
    freq = torch.full((1,), init_freq, dtype=torch.float32, device=dev)
    traj = torch.empty(generations, dtype=torch.float32, device=dev)
    for t in range(generations):
        w = freq * (1 + s)
        p = w / (w + (1 - freq))
        freq = torch.binomial(count, p, generator=gen) / pop_size
        traj[t] = freq[0]
    return traj


# --- groups + Dunn index (reference: popgen/group.go, popgen/dunn.go) ---

@dataclass
class Group:
    name: str
    members: list[str] = field(default_factory=list)


def read_groups(filename: str) -> list[Group]:
    """popgen.ReadGroups (group.go:19)."""
    from . import fileio

    groups: list[Group] = []
    for line in fileio.read(filename):
        if line.startswith(">"):
            groups.append(Group(line[1:]))
        else:
            groups[-1].members.append(line)
    return groups


def filter_mult_by_group(aln, groups: list[Group]):
    """popgen.FilterMultByGroup (group.go:139)."""
    return [rec for rec in aln
            if any(rec.name in g.members for g in groups)]


def find_missing_group_members(aln, groups: list[Group]) -> str:
    """popgen.FindMissingGroupMembers (group.go:118)."""
    present = {rec.name for rec in aln}
    answer = "Missing: "
    for g in groups:
        answer += g.name + ": "
        for member in g.members:
            if member not in present:
                answer += member + ", "
    return answer


def dunn(b, aln, groups: list[Group], realign: bool = False):
    """popgen.Dunn (dunn.go:13): (dunn index, segregating sites,
    missing-members string) for a bed region of a multiFa."""
    from .align import DEFAULT, multi
    from .io import fasta as fastaio

    aln_pos = fastaio.ref_pos_to_aln_pos(aln[0], b.chrom_start)
    aln_end = fastaio.ref_pos_to_aln_pos(aln[0], b.chrom_end)
    tmp = fastaio.copy_subset(aln, aln_pos, aln_end)
    if realign:
        tmp2 = fastaio.remove_gaps(tmp)
        tmp2 = filter_mult_by_group(tmp2, groups)
        tmp3 = multi.all_seq_affine(tmp2, DEFAULT, -400, -30)
    else:
        tmp2 = fastaio.remove_missing_mult(tmp)
        tmp3 = filter_mult_by_group(tmp2, groups)
    if not tmp3:
        return -1.0, 0, ""
    sub_fa = fastaio.dist_column(tmp3)
    missing = find_missing_group_members(sub_fa, groups)
    fa_map = {r.name: r.seq for r in sub_fa}

    from . import dna as dnamod
    max_intra = 0
    for g in groups:
        for i in range(len(g.members)):
            for j in range(i + 1, len(g.members)):
                if g.members[i] in fa_map and g.members[j] in fa_map:
                    max_intra = max(max_intra, dnamod.dist(
                        fa_map[g.members[i]], fa_map[g.members[j]]))
    min_inter = float("inf")
    for mi in groups[0].members:
        for mj in groups[1].members:
            if mi in fa_map and mj in fa_map:
                min_inter = min(min_inter, dnamod.dist(fa_map[mi],
                                                       fa_map[mj]))
    return (min_inter / max_intra,
            fastaio.num_segregating_sites(sub_fa), missing)


# --- Metropolis-Hastings MCMC for selection (popgen/mcmcSelection.go) ---

@dataclass
class McmcSettings:
    iterations: int = 100
    mu_step: float = 0.2
    mu_zero: float = 0.0
    sigma_step: float = 0.2
    sigma_zero: float = 1.0
    unpolarized: bool = False
    divergence_ascertainment: bool = False
    fixed_sigma: bool = False
    d: int = 1
    integral_error: float = 1e-7
    sigma_prior_alpha: float = 2.0
    sigma_prior_beta: float = 10.0
    mu_prior_mean: float = 0.0
    mu_prior_sigma: float = 3.0
    include_ref: bool = False


def afs_likelihood(afs: Afs, alphas, binom_cache,
                   integral_error: float) -> float:
    """popgen.AfsLikelihood (stationarity.go:216): per-site alphas."""
    answer = 0.0
    for site, alpha in zip(afs.sites, alphas):
        answer += allele_frequency_probability(
            site.i, site.n, alpha, binom_cache, integral_error)
    return answer


def _prior_prob(mu: float, sigma: float, s: McmcSettings) -> float:
    from .numbers import distributions as dist

    if sigma < 0:
        return float("-inf")
    sigma_prior = dist.gamma_dist(sigma, s.sigma_prior_alpha,
                                  s.sigma_prior_beta)
    mu_prior = dist.normal_dist(mu, s.mu_prior_mean, s.mu_prior_sigma)
    return math.log(mu_prior * sigma_prior) \
        if mu_prior * sigma_prior > 0 else float("-inf")


def metropolis_hastings(data: Afs, out_file: str, s: McmcSettings,
                        rng) -> None:
    """popgen.MetropolisHastings (mcmcSelection.go:148). rng may be a
    GoRand (byte parity with the reference trace goldens: draw order per
    iteration is sigmaPrime, muPrime, one normal per site, then the
    log-uniform accept draw) or a numpy Generator."""
    from . import fileio

    is_go = hasattr(rng, "float64")

    def norm(mu_, sigma_):
        # SampleInverseNormal (monteCarlo.go:10); negative sigma flips
        # sign exactly as in the reference
        if is_go:
            return rng.norm_float64() * sigma_ + mu_
        return float(rng.standard_normal()) * sigma_ + mu_

    def unif():
        return rng.float64() if is_go else float(rng.random())

    all_n = sorted({site.n for site in data.sites})
    cache = build_binom_cache(all_n)

    if s.divergence_ascertainment:
        def likelihood(alphas):
            return afs_divergence_ascertainment_likelihood(
                data, alphas, cache, s.d, s.integral_error)
    else:
        def likelihood(alphas):
            return afs_likelihood(data, alphas, cache, s.integral_error)

    mu, sigma = s.mu_zero, s.sigma_zero
    alphas = [norm(mu, sigma) for _ in data.sites]
    prior = _prior_prob(mu, sigma, s)
    if prior == float("-inf"):
        raise SystemExit("Initial theta set is too overdispersed to have "
                         "a finite prior density in logSpace.")
    lik = likelihood(alphas)

    with fileio.easy_create(out_file) as out:
        out.write("Iteration\tMu\tSigma\tAccept\n")
        for it in range(s.iterations):
            sigma_prime = (sigma if s.fixed_sigma
                           else norm(sigma, s.sigma_step))
            mu_prime = norm(mu, s.mu_step)
            alphas_prime = [norm(mu_prime, sigma_prime)
                            for _ in data.sites]
            prior_prime = _prior_prob(mu_prime, sigma_prime, s)
            lik_prime = (float("-inf") if prior_prime == float("-inf")
                         else likelihood(alphas_prime))
            if prior_prime == float("-inf") or lik_prime == float("-inf"):
                p_accept = float("-inf")
            else:
                p_accept = (lik_prime - lik) + (prior_prime - prior)
            accept = p_accept > math.log(unif())
            if accept:
                mu, sigma, alphas = mu_prime, sigma_prime, alphas_prime
                prior, lik = prior_prime, lik_prime
            out.write(f"{it}\t{mu:e}\t{sigma:e}\t"
                      f"{'true' if accept else 'false'}\n")


def selection_maximum_likelihood_estimate(data: Afs, *,
                                          left: float = -10.0,
                                          right: float = 10.0,
                                          error: float = 1e-5,
                                          integral_error: float = 1e-7,
                                          divergence_ascertainment:
                                          bool = False,
                                          d: int = 1) \
        -> float:
    """popgen.SelectionMaximumLikelihoodEstimate
    (maximumLikelihood.go:21)."""
    if divergence_ascertainment:
        def f(alpha: float) -> float:
            return afs_divergence_ascertainment_fixed_alpha(
                data, alpha, d, integral_error)
    else:
        def f(alpha: float) -> float:
            return afs_likelihood_fixed_alpha(data, alpha, integral_error)

    return golden_section_max_search(f, left, right, error)
