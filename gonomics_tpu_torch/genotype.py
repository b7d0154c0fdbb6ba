"""Bayesian genotype callers: ``gonomics_tpu/genotype.py`` whole (the
genotype table :21-37, both prior caches :40-64 and :185-198,
``base_log_likelihoods`` :71-113, ``diploid_base_call`` :116-144,
``diploid_base_call_batch`` :147-163 and ``haploid_base_call``
:166-182).

The diploid caller scores 10 genotypes from a pile's ACGT counts: a
flat error rate epsilon, or with lam > 0 the ancient-DNA model of
cytosine deamination, plus priors that tell transitions from
transversions. The likelihoods are torch float64 on the device of the
counts they are given. The per-pile callers run one row on the CPU;
``diploid_base_call_batch`` runs (P, 4) counts on the card unless the
caller passes ``device="cpu"``, with the JAX's float64 operations in the
JAX's order, so its calls equal the JAX's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dna, resolve_device
from .pileup import Pile

(AA, AC, AG, AT, CC, CG, CT, GG, GT, TT, NN) = range(11)

GENOTYPE_STRINGS = ["AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT",
                    "TT", "NN"]

_GENO_BASES = [(dna.A, dna.A), (dna.A, dna.C), (dna.A, dna.G),
               (dna.A, dna.T), (dna.C, dna.C), (dna.C, dna.G),
               (dna.C, dna.T), (dna.G, dna.G), (dna.G, dna.T),
               (dna.T, dna.T), (dna.N, dna.N)]

# the homozygous-reference genotype of A, C, G and T
_HOM_REF = (AA, CC, GG, TT)


def diploid_base_to_bases(geno: int):
    return _GENO_BASES[geno]


def ref_base_to_ref_genotype(ref: int) -> int:
    return {dna.A: AA, dna.C: CC, dna.G: GG, dna.T: TT, dna.N: NN}[ref]


def make_diploid_base_prior_cache(delta: float, gamma: float) -> np.ndarray:
    """(4 refs x 10 genotypes) log priors with Tv = delta / (2 + gamma)
    and Tr = gamma * Tv (diploidBase.go:259)."""
    tv = delta / (2.0 + gamma)
    tr = gamma * tv
    omd2 = math.log((1 - delta) ** 2)
    tv2 = math.log(tv * tv)
    tr2 = math.log(tr * tr)
    tvtr = math.log(tv * tr)
    two_tv2 = math.log(2 * tv * tv)
    two_omd_tv = math.log(2 * (1 - delta) * tv)
    two_omd_tr = math.log(2 * (1 - delta) * tr)
    return np.array([
        [omd2, two_omd_tv, two_omd_tr, two_omd_tv, tv2, tvtr, two_tv2,
         tr2, tvtr, tv2],
        [tv2, two_omd_tv, two_tv2, tvtr, omd2, two_omd_tv, two_omd_tr,
         tv2, tvtr, tr2],
        [tr2, tvtr, two_omd_tr, tvtr, tv2, two_omd_tv, two_tv2, omd2,
         two_omd_tv, tv2],
        [tv2, tvtr, two_tv2, two_omd_tv, tr2, tvtr, two_omd_tr, two_tv2,
         two_omd_tv, omd2]])


def make_diploid_base_flat_prior_cache() -> np.ndarray:
    return np.full((4, 10), math.log(0.1))


def _log(x: float) -> float:
    return math.log(x) if x > 0 else float("-inf")


def base_log_likelihoods(counts, epsilon: float,
                         lam: float = 0.0) -> torch.Tensor:
    """(P, 10) float64 log likelihoods from (P, 4) ACGT counts, on the
    counts' device (a numpy array goes to the CPU). lam > 0 switches to
    the deamination model (ancientDiploidBase.go:28)."""
    counts = torch.atleast_2d(torch.as_tensor(counts, dtype=torch.float64))
    a, c, g, t = counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3]
    e3 = _log(epsilon / 3.0)
    if lam <= 0:
        ome = _log(1.0 - epsilon)
        het = _log(0.5 - epsilon / 3.0)
        cols = [
            ome * a + e3 * (c + g + t),              # AA
            het * (a + c) + e3 * (g + t),            # AC
            het * (a + g) + e3 * (c + t),            # AG
            het * (a + t) + e3 * (c + g),            # AT
            ome * c + e3 * (a + g + t),              # CC
            het * (c + g) + e3 * (a + t),            # CG
            het * (c + t) + e3 * (a + g),            # CT
            ome * g + e3 * (a + c + t),              # GG
            het * (g + t) + e3 * (a + c),            # GT
            ome * t + e3 * (a + c + g),              # TT
        ]
    else:
        ome_l = _log(1.0 - epsilon - lam)
        e3_l = _log(epsilon / 3.0 + lam)
        h = _log(0.5 - epsilon / 3.0)
        e3_l2 = _log(epsilon / 3.0 + lam / 2.0)
        h_pl2 = _log(0.5 - epsilon / 3.0 + lam / 2.0)
        h_ml2 = _log(0.5 - epsilon / 3.0 - lam / 2.0)
        ome = _log(1.0 - epsilon)
        cols = [
            ome * a + e3 * (c + g + t),                       # AA
            h * a + h_ml2 * c + e3 * g + e3_l2 * t,           # AC
            h_pl2 * a + e3 * (c + t) + h_ml2 * g,             # AG
            h * (a + t) + e3 * (c + g),                       # AT
            e3 * (a + g) + ome_l * c + e3_l * t,              # CC
            e3_l2 * a + h_ml2 * (c + g) + e3_l2 * t,          # CG
            e3 * (a + g) + h_ml2 * c + h_pl2 * t,             # CT
            e3_l * a + e3 * (c + t) + ome_l * g,              # GG
            e3_l2 * a + e3 * c + h_ml2 * g + h * t,           # GT
            e3 * (a + c + g) + ome * t,                       # TT
        ]
    return torch.stack(cols, dim=1)


def _pile_counts(p: Pile) -> torch.Tensor:
    """A pile's ACGT counts over both strands, as one float64 CPU row."""
    return torch.tensor([[float(p.count_f[b] + p.count_r[b])
                          for b in (dna.A, dna.C, dna.G, dna.T)]],
                        dtype=torch.float64)


def diploid_base_call(p: Pile, ref_base: int, prior_cache: np.ndarray,
                      epsilon: float, lam: float = 0.0) -> int:
    """A pile's genotype (DiploidBaseCallFromPile, diploidBase.go:112).
    Ties go to the lowest genotype index, where the reference picks
    among them with its seeded generator."""
    if ref_base == dna.N:
        return NN
    counts = _pile_counts(p)
    if float(counts.sum()) < 1:
        return ref_base_to_ref_genotype(ref_base)
    post = (base_log_likelihoods(counts, epsilon, lam)[0]
            + torch.as_tensor(np.asarray(prior_cache)[ref_base],
                              dtype=torch.float64)).tolist()
    # the reference seeds the best value with the homozygous-reference
    # genotype and replaces it only on a strictly greater one, scanning
    # genotypes 0..9: a tie with it keeps the lower index
    best = post[ref_base_to_ref_genotype(ref_base)]
    winners = [ref_base_to_ref_genotype(ref_base)]
    for geno in range(10):
        v = post[geno]
        if v > best:
            best = v
            winners = [geno]
        elif v == best and geno != winners[0]:
            winners.append(geno)
    return winners[0]


def diploid_base_call_batch(counts, ref_bases, prior_cache, epsilon: float,
                            lam: float = 0.0, device=None) -> np.ndarray:
    """(P,) int8 genotypes of (P, 4) ACGT counts and (P,) reference base
    codes, computed on ``resolve_device(device)`` (the card unless the
    caller passes ``device="cpu"``): the float64 posteriors, torch's
    argmax (the first maximum, or the first NaN, as numpy's), then the
    homozygous-reference call where a row counts under one read, and NN
    where the reference is N."""
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, dtype=torch.float64, device=dev)
    ref = torch.as_tensor(ref_bases, dtype=torch.int64, device=dev)
    ll = base_log_likelihoods(counts, epsilon, lam)
    prior = torch.as_tensor(prior_cache, dtype=torch.float64,
                            device=dev)[ref.clamp(0, 3)]
    post = ll + prior
    calls = torch.argmax(post, dim=1).to(torch.int8)
    hom = torch.tensor(_HOM_REF, dtype=torch.int8, device=dev)
    hom_ref = torch.where(ref <= 3, hom[ref.clamp(0, 3)],
                          torch.tensor(NN, dtype=torch.int8, device=dev))
    empty = counts.sum(dim=1) < 1
    calls = torch.where(empty, hom_ref, calls)
    calls = torch.where(ref == dna.N, torch.tensor(
        NN, dtype=torch.int8, device=dev), calls)
    return calls.cpu().numpy()


def haploid_base_call(p: Pile, ref_base: int, epsilon: float,
                      prior_cache: np.ndarray, lam: float = 0.0) -> int:
    """The best of the four homozygous genotypes under haploid priors, as
    a base code (HaploidCallFromPile's base part, haploid.go:21)."""
    if ref_base == dna.N:
        return dna.N
    counts = _pile_counts(p)
    if float(counts.sum()) < 1:
        return ref_base
    ll = base_log_likelihoods(counts, epsilon, lam)[0].tolist()
    homos = [AA, CC, GG, TT]
    prior = np.asarray(prior_cache)[ref_base]
    post = [ll[homos[b]] + prior[b] for b in range(4)]
    return int(np.argmax(post))


def make_haploid_base_prior_cache(delta: float, gamma: float) -> np.ndarray:
    """(4 refs x 4 bases) log priors of a haploid base, transitions and
    transversions apart."""
    tv = delta / (2.0 + gamma)
    tr = gamma * tv
    out = np.full((4, 4), _log(tv))
    transitions = {(dna.A, dna.G), (dna.G, dna.A), (dna.C, dna.T),
                   (dna.T, dna.C)}
    for r in range(4):
        for b in range(4):
            if r == b:
                out[r, b] = _log(1 - delta)
            elif (r, b) in transitions:
                out[r, b] = _log(tr)
    return out
