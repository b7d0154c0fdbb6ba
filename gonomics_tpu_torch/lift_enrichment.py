"""Overlap-enrichment p-values over interval records, as
overlapEnrichments computes them: a copy of
``gonomics_tpu/lift_enrichment.py`` (214 lines, whole; gonomics'
``interval/lift/{enrichment,info}.go``).

``go_read`` reads a VCF (any name that holds ``.vcf``) or a bed as plain
spans. The exact method is the Poisson-binomial DP in log space, O(n^2)
in Python; the approximate method sums normal densities; the bounds take
one binomial at the longest (upper) or shortest (lower) element. The
float64 steps are the JAX package's, in its order.
"""

from __future__ import annotations

import functools
import math

from .io import bed as bedio
from .io import vcf as vcfio
from .numbers import distributions as dist
from .numbers import logspace


def go_read(filename: str) -> list[bedio.Bed]:
    """lift.GoRead: a VCF's records as spans (a one-base REF at pos - 1,
    a longer one from pos), else a bed's records."""
    if ".vcf" in filename:
        out = []
        for v in vcfio.read(filename)[0]:
            if len(v.ref) == 1:
                out.append(bedio.Bed(chrom=v.chrom, chrom_start=v.pos - 1,
                                     chrom_end=v.pos))
            else:
                out.append(bedio.Bed(chrom=v.chrom, chrom_start=v.pos,
                                     chrom_end=v.pos + len(v.ref) - 1))
        return out
    return bedio.read(filename)


def _cmp_coord(a: bedio.Bed, b: bedio.Bed) -> int:
    if a.chrom != b.chrom:
        return -1 if a.chrom < b.chrom else 1
    for u, v in ((a.chrom_start, b.chrom_start),
                 (a.chrom_end, b.chrom_end)):
        if u != v:
            return -1 if u < v else 1
    return 0


def sort_by_coord(recs: list[bedio.Bed]) -> None:
    recs.sort(key=functools.cmp_to_key(_cmp_coord))


def _overlap(a: bedio.Bed, b: bedio.Bed) -> bool:
    return (a.chrom == b.chrom
            and max(a.chrom_start, b.chrom_start)
            < min(a.chrom_end, b.chrom_end))


def is_self_overlapping(recs: list[bedio.Bed]) -> bool:
    """lift.IsSelfOverlapping (info.go:100): any sorted neighbours
    overlap."""
    return any(_overlap(recs[i], recs[i + 1])
               for i in range(len(recs) - 1))


def _cmp_end_by_chrom(a: bedio.Bed, b: bedio.Bed) -> int:
    if a.chrom != b.chrom:
        return -1 if a.chrom < b.chrom else 1
    if a.chrom_end != b.chrom_end:
        return -1 if a.chrom_end < b.chrom_end else 1
    return 0


def overlap_count(a: list[bedio.Bed], b: list[bedio.Bed]) -> int:
    """lift.OverlapCount (info.go:12): the elements of a that overlap any
    of b, both sorted."""
    count = ai = bi = 0
    while ai < len(a) and bi < len(b):
        if _overlap(a[ai], b[bi]):
            count += 1
            ai += 1
        elif _cmp_end_by_chrom(a[ai], b[bi]) < 0:
            ai += 1
        else:
            bi += 1
    return count


def _subtract_from_coord(regions: list[bedio.Bed], sub_start: int,
                         sub_end: int) -> list[bedio.Bed]:
    """subtractFromCoord (enrichment.go:216): spans shrunk, kept apart by
    the clamp at the previous span's end."""
    out: list[bedio.Bed] = []
    prev_end = 0
    prev_chrom = ""
    for r in regions:
        if prev_chrom == "" or prev_chrom != r.chrom:
            prev_chrom = r.chrom
            prev_end = 0
        new = bedio.Bed(chrom=r.chrom,
                        chrom_start=max(prev_end,
                                        r.chrom_start - sub_start),
                        chrom_end=max(r.chrom_start,
                                      r.chrom_end - sub_end),
                        fields_initialized=3)
        prev_end = new.chrom_end
        out.append(new)
    return out


def _overlap_length_sum(a: list[bedio.Bed], b: list[bedio.Bed]) -> int:
    total = ai = bi = 0
    while ai < len(a) and bi < len(b):
        if _overlap(a[ai], b[bi]):
            total += (min(a[ai].chrom_end, b[bi].chrom_end)
                      - max(a[ai].chrom_start, b[bi].chrom_start))
        if _cmp_end_by_chrom(a[ai], b[bi]) < 0:
            ai += 1
        else:
            bi += 1
    return total


def _overlap_probability(elements: list[bedio.Bed], length: int,
                         no_gap: list[bedio.Bed]) -> float:
    """overlapProbability (info.go:31): the share of the search space's
    start positions at which an element of this length overlaps one of
    elements."""
    shrunk_elements = _subtract_from_coord(elements, length - 1, 0)
    shrunk_no_gap = _subtract_from_coord(no_gap, 0, length - 1)
    total = sum(r.chrom_end - r.chrom_start for r in shrunk_no_gap)
    return _overlap_length_sum(shrunk_elements, shrunk_no_gap) / total


def element_overlap_probabilities(e1: list[bedio.Bed],
                                  e2: list[bedio.Bed],
                                  no_gap: list[bedio.Bed]) -> list[float]:
    """lift.ElementOverlapProbabilities (enrichment.go:13): one
    probability an element of e2, in ascending order of span length."""
    sizes = sorted(r.chrom_end - r.chrom_start for r in e2)
    answer: list[float] = []
    prev_len = 0
    for i, length in enumerate(sizes):
        if i > 0 and length == prev_len:
            answer.append(answer[-1])
        else:
            answer.append(_overlap_probability(e1, length, no_gap))
            prev_len = length
    return answer


def enrichment_p_value_exact(probs: list[float],
                             overlap: int) -> list[float]:
    """lift.EnrichmentPValueExact (enrichment.go:74): [the pmf's total,
    the expected overlap, P(X >= overlap), P(X <= overlap)] of the
    Poisson-binomial, its DP in log space."""
    n = len(probs)
    prev = [0.0] * (n + 1)
    curr = [0.0] * (n + 1)
    prev[0] = logspace.go_log(1 - probs[0])
    curr[0] = prev[0]
    prev[1] = logspace.go_log(probs[0])
    curr[1] = prev[1]
    for t in range(1, n):
        prev, curr = curr, prev
        curr[0] = prev[0] + logspace.go_log(1 - probs[t])
        for s in range(1, t + 1):
            curr[s] = logspace.add(
                prev[s] + logspace.go_log(1 - probs[t]),
                prev[s - 1] + logspace.go_log(probs[t]))
        curr[t + 1] = prev[t] + logspace.go_log(probs[t])

    check = curr[0]
    expected = 0.0
    for s in range(1, n + 1):
        check = logspace.add(check, curr[s])
        if s == 1:
            expected = curr[s]
        else:
            expected = logspace.add(expected,
                                    curr[s] + logspace.go_log(float(s)))
    enrich = curr[overlap]
    for s in range(overlap + 1, n + 1):
        enrich = logspace.add(enrich, curr[s])
    deplete = curr[overlap]
    for s in range(overlap - 1, -1, -1):
        deplete = logspace.add(deplete, curr[s])
    return [math.exp(check), math.exp(expected), math.exp(enrich),
            math.exp(deplete)]


def enrichment_p_value_approximation(probs: list[float],
                                     overlap: int) -> list[float]:
    """lift.EnrichmentPValueApproximation (enrichment.go:40): normal
    densities at the integers summed for each tail."""
    mu = sum(probs)
    sigma = math.sqrt(sum(p * (1 - p) for p in probs))
    enrich = sum(dist.normal_dist(float(s), mu, sigma)
                 for s in range(overlap, len(probs) + 1))
    deplete = sum(dist.normal_dist(float(s), mu, sigma)
                  for s in range(overlap, -1, -1))
    return [1.0, mu, enrich, deplete]


def _binomial_tail(n: int, overlap: int, p: float,
                   upper: bool) -> float:
    rng = (range(overlap, n + 1) if upper
           else range(overlap, -1, -1))
    return sum(dist.binomial_dist(n, s, p) for s in rng)


def enrichment_p_value_bound(e1: list[bedio.Bed], e2: list[bedio.Bed],
                             no_gap: list[bedio.Bed], overlap: int,
                             upper: bool) -> list[float]:
    """lift.EnrichmentPValue{Upper,Lower}Bound (enrichment.go:130, 173):
    both tails of one binomial of len(e2) trials at the probability of
    e2's longest (upper) or shortest element."""
    n = len(e2)
    sizes = [r.chrom_end - r.chrom_start for r in e2]
    length = max(sizes) if upper else min(sizes)
    prob = _overlap_probability(e1, length, no_gap)
    enrich = _binomial_tail(n, overlap, prob, True)
    deplete = _binomial_tail(n, overlap, prob, False)
    return [1.0, prob * n, enrich, deplete]
