"""simulateBed, simulateVcf, simulateDivergentWindowsVcf and
simulatePcr: a copy of ``gonomics_tpu/cli/simulate_tools.py`` (441
lines, whole), gonomics' ``cmd/{simulateBed,simulateVcf,
simulateDivergentWindowsVcf,simulatePcr}`` with ``simulate/{bed,vcf}.go``
and ``popgen/afsSimulate.go``, their flags, defaults and error texts
unchanged. The umbrella reaches each through its ``module:function``
target (``main_bed``, ``main_vcf``, ``main_divergent_windows``,
``main_pcr``).

    gonomics-torch simulateBed noGap.bed out.bed [-N 10] [-L 1000]
        [-matchedBed m.bed] [-setSeed -1]
    gonomics-torch simulateVcf out.vcf [-numSites 10] [-alpha 0.01]
        [-numAlleles 10] [-boundAlpha 0.001] [-boundBeta 0.001]
        [-boundMultiplier 10000] [-refFile ref.fa] [-setSeed -1]
    gonomics-torch simulateDivergentWindowsVcf lower.vcf upper.vcf
        [-numTotalSites 20] [-numWindowSites 10] [-numWindows 10]
        [-lowerPercentile 0.1] [-upperPercentile 0.9] [-alpha 0.01]
        [-numAlleles 10] [-setSeed -1]
    gonomics-torch simulatePcr -p PRIMER [-p PRIMER ...] -t ref.fa
        [-bed out.bed] [-fastq out.fq] [-maxProductSize 1000]
        [-includePrimer=false]

Every command but simulatePcr, which draws nothing, draws from the
emulated Go rand stream (``numbers/gorand``, ``GoRand(setSeed)``), so
each replays the JAX tool's bytes and gonomics' own.

The reference's quirks stay. simulateBed skips a no-gap region shorter
than ``-L`` and writes 4 fields only where the region has a name.
simulateVcf's ``-refFile`` path cuts the region name at its first
``_`` for the chrom and keys its dedup by the chrom-local start alone,
so a start drawn on one chrom blocks it on every other.
simulateDivergentWindowsVcf re-seeds with ``setSeed * w`` before window
``w`` and shuffles the one site list in place, so the shuffles
accumulate. simulatePcr upper-cases the template but not the primers,
steps past each hit, and pairs only the last forward site before a
reverse site.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from .. import dna, fileio, popgen
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io import vcf as vcfio
from ..numbers.gorand import GoRand
from ..numbers.gosamplers import (bounded_rejection_sample,
                                 scaled_beta_sampler)
from ..simulate import _go_change_base
from .vcf_filter import is_alt_ancestor


# --- simulateBed (simulate/bed.go) ---

def count_windows(search_space: list[bedio.Bed], length: int) -> int:
    """simulate.CountWindows (bed.go:10)."""
    return sum(b.chrom_end - b.chrom_start - length + 1
               for b in search_space
               if b.chrom_end - b.chrom_start >= length)


def generate_bed_region(search_space: list[bedio.Bed], rand_pos: int,
                        length: int):
    """simulate.GenerateBedRegion (bed.go:24)."""
    for b in search_space:
        windows = (b.chrom_end - b.chrom_start) - length + 1
        if windows < 1:
            continue
        if rand_pos - windows > -1:
            rand_pos -= windows
        else:
            if b.name == "":
                return bedio.Bed(b.chrom, b.chrom_start + rand_pos,
                                 b.chrom_start + rand_pos + length,
                                 fields_initialized=3), True
            return bedio.Bed(b.chrom, b.chrom_start + rand_pos,
                             b.chrom_start + rand_pos + length, b.name,
                             fields_initialized=4), True
    return bedio.Bed(), False


def simulate_bed(region_count: int, sim_length: int, matched_bed: str,
                 no_gap_file: str, out_file: str,
                 set_seed: int = -1) -> None:
    """cmd/simulateBed + simulate.GoSimulateBed (bed.go:67): positions
    drawn from the bit-exact Go rand stream (byte-equal goldens)."""
    rng = GoRand(set_seed)
    no_gap = bedio.read(no_gap_file)
    if matched_bed:
        matched = bedio.read(matched_bed)
        # bed.AverageSize (info.go:114): math.Round of the float mean
        avg = sum(b.chrom_end - b.chrom_start
                  for b in matched) / len(matched)
        sim_length = int(avg + 0.5)
        region_count = len(matched)
    total = count_windows(no_gap, sim_length)
    with fileio.easy_create(out_file) as out:
        for _ in range(region_count):
            pos = int(rng.float64() * total)  # numbers.RandIntInRange
            region, found = generate_bed_region(no_gap, pos, sim_length)
            if found:
                bedio.write_to_handle(out, region)


# --- simulateVcf (simulate/vcf.go, popgen/afsSimulate.go) ---

def simulate_seg_site(rng, alpha: float, n: int, bound_alpha: float,
                      bound_beta: float, bound_multiplier: float):
    """popgen.SimulateSegSite (afsSimulate.go:13), exact Go draw order
    via the emulated rand stream (rng: gorand.GoRand)."""
    bound = scaled_beta_sampler(rng, bound_alpha, bound_beta,
                                bound_multiplier)

    def f(x):
        try:
            return popgen.afs_stationarity(x, alpha)
        except (ZeroDivisionError, OverflowError):
            return math.inf  # Go float semantics at the domain edges

    for _ in range(1000000):
        freq, _ = bounded_rejection_sample(rng, bound, f, 0.0, 1.0,
                                           10000000)
        count = 0
        for _ in range(n):
            if rng.float64() < freq:
                count += 1
        if count < 1 or count == n:
            continue
        divergent = rng.float64() < freq
        return count, n, divergent
    raise SystemExit("unable to produce non-zero allele frequency")


def simulate_genotype(rng, alpha: float, n: int, bound_alpha: float,
                      bound_beta: float, bound_multiplier: float):
    """popgen.SimulateGenotype (afsSimulate.go:50)."""
    i, total, divergent = simulate_seg_site(rng, alpha, n, bound_alpha,
                                            bound_beta, bound_multiplier)
    if divergent:
        i = total - i
    alleles = [1] * i + [0] * (total - i)

    def swap(a, b):
        alleles[a], alleles[b] = alleles[b], alleles[a]

    rng.shuffle(total, swap)
    samples = []
    for c in range(0, total, 2):
        if c + 1 >= total:
            pair = [alleles[c], -1]
        else:
            pair = [alleles[c], alleles[c + 1]]
        s = vcfio.Sample()
        s.alleles = pair
        s.phase = [False, False]
        s.format_data = [""]
        samples.append(s)
    return samples, divergent


def single_vcf_random(rng, alpha: float, num_alleles: int,
                      bound_alpha: float, bound_beta: float,
                      bound_multiplier: float, pos: int) -> vcfio.Vcf:
    """simulate.SingleVcfRandom (vcf.go:95)."""
    genotype, divergent = simulate_genotype(rng, alpha, num_alleles,
                                            bound_alpha, bound_beta,
                                            bound_multiplier)
    v = vcfio.Vcf(chrom="chr1", pos=pos, id=".", ref="A", alt=["T"],
                  qual=100, filter=".", info=".", format=["GT"],
                  samples=genotype)
    return vcfio.append_ancestor(v, v.alt[0] if divergent else v.ref)


def simulate_vcf(out_file: str, *, alpha: float = 0.01,
                 num_alleles: int = 10, num_sites: int = 10,
                 set_seed: int = -1, bound_alpha: float = 0.001,
                 bound_beta: float = 0.001,
                 bound_multiplier: float = 10000.0,
                 ref_file: str = "") -> None:
    rng = GoRand(set_seed)
    with fileio.easy_create(out_file) as out:
        if not ref_file:
            for i in range(num_sites):
                vcfio.write_vcf(out, single_vcf_random(
                    rng, alpha, num_alleles, bound_alpha, bound_beta,
                    bound_multiplier, i + 1))
            return
        # VcfToFile's reference-genome path (vcf.go:28)
        ref = fastaio.read(ref_file)
        regions = _ungapped_regions_all(ref)
        fa_idx = {r.name: i for i, r in enumerate(ref)}
        total = count_windows(regions, 1)
        # mapSearchSpaceToOffset keys by FULL region name but is probed
        # with the '_'-stripped chrom (vcf.go:44-51) — the lookup always
        # misses (Go zero value 0), so the dedup key is the chrom-local
        # start and COLLIDES across chromosomes. Replicated faithfully.
        generated: set[int] = set()
        produced = 0
        while produced < num_sites:
            pos = int(rng.float64() * total)  # RandIntInRange
            region, _ = generate_bed_region(regions, pos, 1)
            chrom = region.name.split("_")[0]
            key = region.chrom_start
            if key in generated:
                continue
            generated.add(key)
            ref_base = int(np.asarray(
                ref[fa_idx[chrom]].seq)[region.chrom_start])
            genotype, divergent = simulate_genotype(
                rng, alpha, num_alleles, bound_alpha, bound_beta,
                bound_multiplier)
            alt = _change_base(rng, ref_base)
            v = vcfio.Vcf(chrom=chrom, pos=region.chrom_start + 1,
                          id=".",
                          ref=dna.to_string(np.array([ref_base],
                                                     np.int8)),
                          alt=[dna.to_string(np.array([alt], np.int8))],
                          qual=100, filter=".", info=".", format=["GT"],
                          samples=genotype)
            v = vcfio.append_ancestor(v, v.alt[0] if divergent else
                                      v.ref)
            vcfio.write_vcf(out, v)
            produced += 1


# simulate.changeBase (simulate.go:130): ChooseRandomBase at the package
# GC constant 0.42 until it differs; the read simulator's own loop
_change_base = _go_change_base


def _ungapped_regions_all(records):
    """bed.UngappedRegionsAllFromFa (bed/info.go:79)."""
    answer = []
    for rec in records:
        seq = np.asarray(rec.seq)
        is_base = (seq <= dna.T) | ((seq >= dna.LOWER_A)
                                    & (seq <= dna.LOWER_T))
        in_region = False
        start = 0
        for i, b in enumerate(is_base):
            if b and not in_region:
                in_region, start = True, i
            elif not b and in_region:
                answer.append(bedio.Bed(rec.name, start, i,
                                        f"{rec.name}_{start}_{i}",
                                        fields_initialized=4))
                in_region = False
        if in_region:
            answer.append(bedio.Bed(rec.name, start, len(seq),
                                    f"{rec.name}_{start}_{len(seq)}",
                                    fields_initialized=4))
    return answer


# --- simulateDivergentWindowsVcf ---

def simulate_divergent_windows_vcf(out_lower: str, out_upper: str, *,
                                   alpha: float = 0.01,
                                   num_alleles: int = 10,
                                   num_total_sites: int = 20,
                                   num_window_sites: int = 10,
                                   num_windows: int = 10,
                                   lower_percentile: float = 0.1,
                                   upper_percentile: float = 0.9,
                                   bound_alpha: float = 0.001,
                                   bound_beta: float = 0.001,
                                   bound_multiplier: float = 10000.0,
                                   set_seed: int = -1) -> None:
    """cmd/simulateDivergentWindowsVcf."""
    if num_window_sites > num_total_sites:
        raise SystemExit("The number of total simulated Vcf variants "
                         "must be greater than the desired number of "
                         "variants per window.")
    rng = GoRand(set_seed)
    sites = [single_vcf_random(rng, alpha, num_alleles, bound_alpha,
                               bound_beta, bound_multiplier, i + 1)
             for i in range(num_total_sites)]
    windows = []
    for w in range(num_windows):
        # the reference RE-SEEDS with setSeed*i and shuffles TotalSites
        # IN PLACE each window (cumulative), then takes the head
        rng.seed(set_seed * w)

        def swap(i, j):
            sites[i], sites[j] = sites[j], sites[i]

        rng.shuffle(len(sites), swap)
        chosen = list(sites[:num_window_sites])
        windows.append((sum(1 for v in chosen if is_alt_ancestor(v)),
                        chosen))
    windows.sort(key=lambda w: w[0])
    with fileio.easy_create(out_lower) as out:
        for _, chosen in windows[:int(lower_percentile * num_windows)]:
            for v in chosen:
                vcfio.write_vcf(out, v)
    with fileio.easy_create(out_upper) as out:
        for _, chosen in windows[int(upper_percentile * num_windows):]:
            for v in chosen:
                vcfio.write_vcf(out, v)


# --- simulatePcr (deterministic) ---

def _find_priming_sites(template: str, primer: str,
                        fwd: bool) -> list[tuple[str, int]]:
    """findPrimingSites (simulatePcr.go:160)."""
    sites = []
    offset = 0
    while template:
        pos = template.find(primer)
        if pos == -1:
            break
        if fwd:
            pos += len(primer)
        sites.append((primer, offset + pos))
        if not fwd:
            pos += len(primer)
        offset += pos
        template = template[pos:]
    return sites


def _calc_products(chrom: str, fwd_sites, rev_sites, max_len: int,
                   include_primer: bool) -> list[bedio.Bed]:
    """calcProducts (simulatePcr.go:184)."""
    out: list[bedio.Bed] = []
    if not fwd_sites or not rev_sites:
        return out
    rev_idx = 0
    for i, (primer, start) in enumerate(fwd_sites):
        while start >= rev_sites[rev_idx][1]:
            rev_idx += 1
            if rev_idx >= len(rev_sites):
                return out
        if i + 1 < len(fwd_sites) \
                and fwd_sites[i + 1][1] < rev_sites[rev_idx][1]:
            continue
        s, e = start, rev_sites[rev_idx][1]
        if include_primer:
            s -= len(primer)
            e += len(rev_sites[rev_idx][0])
        if e - s <= max_len:
            rev_orig = dna.to_string(dna.reverse_complement(
                np.array(dna.from_string(rev_sites[rev_idx][0]),
                         copy=True)))
            out.append(bedio.Bed(chrom, s, e, f"{primer}+{rev_orig}",
                                 fields_initialized=4))
    return out


def simulate_pcr(primers: list[str], ref: str, out_bed: str = "",
                 out_fastq: str = "", max_len: int = 1000,
                 include_primer: bool = True) -> None:
    """simulatePcr (simulatePcr.go:51)."""
    if max_len == 0:
        max_len = 1 << 62
    records = fastaio.read(ref)
    rev_primers = [dna.to_string(dna.reverse_complement(
        np.array(dna.from_string(p), copy=True))) for p in primers]
    out_b = fileio.easy_create(out_bed) if out_bed else None
    out_fq = fileio.easy_create(out_fastq) if out_fastq else None
    count = 0
    for rec in records:
        template = dna.to_string(dna.to_upper(np.asarray(rec.seq)))
        fwd_sites: list[tuple[str, int]] = []
        rev_sites: list[tuple[str, int]] = []
        for p, rp in zip(primers, rev_primers):
            fwd_sites.extend(_find_priming_sites(template, p, True))
            rev_sites.extend(_find_priming_sites(template, rp, False))
        fwd_sites.sort(key=lambda s: s[1])
        rev_sites.sort(key=lambda s: s[1])
        for b in _calc_products(rec.name, fwd_sites, rev_sites, max_len,
                                include_primer):
            if out_b:
                bedio.write_to_handle(out_b, b)
            if out_fq:
                seq = template[b.chrom_start:b.chrom_end]
                out_fq.write(f"@{b.chrom}:{b.chrom_start}-{b.chrom_end}"
                             f"_{b.name}\n{seq}\n+\n"
                             + "I" * len(seq) + "\n")
            count += 1
    if out_b:
        out_b.close()
    if out_fq:
        out_fq.close()
    print(f"found {count} potential products")


def main_bed(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateBed")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-matchedBed", default="")
    p.add_argument("-L", type=int, default=1000)
    p.add_argument("-N", type=int, default=10)
    p.add_argument("-setSeed", type=int, default=-1)
    a = p.parse_args(argv)
    simulate_bed(a.N, a.L, a.matchedBed, a.input, a.output, a.setSeed)


def main_vcf(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateVcf")
    p.add_argument("output")
    p.add_argument("-numSites", type=int, default=10)
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-alpha", type=float, default=0.01)
    p.add_argument("-numAlleles", type=int, default=10)
    p.add_argument("-boundAlpha", type=float, default=0.001)
    p.add_argument("-boundBeta", type=float, default=0.001)
    p.add_argument("-boundMultiplier", type=float, default=10000)
    p.add_argument("-refFile", default="")
    a = p.parse_args(argv)
    simulate_vcf(a.output, alpha=a.alpha, num_alleles=a.numAlleles,
                 num_sites=a.numSites, set_seed=a.setSeed,
                 bound_alpha=a.boundAlpha, bound_beta=a.boundBeta,
                 bound_multiplier=a.boundMultiplier, ref_file=a.refFile)


def main_divergent_windows(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateDivergentWindowsVcf")
    p.add_argument("lowerOut")
    p.add_argument("upperOut")
    p.add_argument("-alpha", type=float, default=0.01)
    p.add_argument("-numAlleles", type=int, default=10)
    p.add_argument("-numTotalSites", type=int, default=20)
    p.add_argument("-numWindowSites", type=int, default=10)
    p.add_argument("-numWindows", type=int, default=10)
    p.add_argument("-lowerPercentile", type=float, default=0.1)
    p.add_argument("-upperPercentile", type=float, default=0.9)
    p.add_argument("-setSeed", type=int, default=-1)
    a = p.parse_args(argv)
    simulate_divergent_windows_vcf(
        a.lowerOut, a.upperOut, alpha=a.alpha, num_alleles=a.numAlleles,
        num_total_sites=a.numTotalSites,
        num_window_sites=a.numWindowSites, num_windows=a.numWindows,
        lower_percentile=a.lowerPercentile,
        upper_percentile=a.upperPercentile, set_seed=a.setSeed)


def main_pcr(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulatePcr")
    p.add_argument("-p", action="append", default=[], dest="primers")
    p.add_argument("-t", required=True)
    p.add_argument("-bed", default="")
    p.add_argument("-fastq", default="")
    p.add_argument("-maxProductSize", type=int, default=1000)
    p.add_argument("-includePrimer", nargs="?", const="true",
                   default="true",
                   help="Go-style bool: -includePrimer=false to disable")
    a = p.parse_args(argv)
    if not a.primers:
        raise SystemExit("ERROR: primer sequence must be declared at "
                         "least once using -p")
    simulate_pcr(a.primers, a.t, a.bed, a.fastq, a.maxProductSize,
                 a.includePrimer.lower() in ("true", "1", "t"))
