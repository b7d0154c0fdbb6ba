"""selectionMle, selectionMcmc, dunnIndex, mcmcTraceStats and
simulateWrightFisher, a copy of ``gonomics_tpu/cli/popgen_tools.py``
(346 lines, whole), gonomics' ``cmd/{selectionMle,selectionMcmc,
dunnIndex,mcmcTraceStats,simulateWrightFisher}``, their flags, defaults
and error texts unchanged. The umbrella reaches each through its
``module:function`` target (``main_mle``, ``main_mcmc``, ``main_dunn``,
``main_trace_stats``, ``main_wright_fisher``).

    gonomics-torch selectionMle in.vcf out.txt [-unPolarized]
        [-divergenceAscertainment] [-includeRef] [-integralError 1e-7]
    gonomics-torch selectionMcmc in.vcf out.trace [-iterations 100]
        [-setSeed -1] ...
    gonomics-torch dunnIndex in.bed aln.fa groups.list out.bed [-realign]
    gonomics-torch mcmcTraceStats in.trace out.txt [-hdiProportion 0.95]
        [-burnIn 0] [-parameterName Mu]
    gonomics-torch simulateWrightFisher out.tsv [-N 100] [-m 0.1] [-t 500]
        [-g 1] [-w 1] [-gc 0.5] [-i f,f,f,f,B] [-W w,w,w,w,B]
        [-setSeed 1] [-f]

selectionMcmc and simulateWrightFisher both draw from the emulated Go
rand stream (``numbers/gorand``) seeded with ``-setSeed``, so each run
replays the JAX tool's bytes and gonomics' own.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from .. import fileio, popgen
from ..fileio import go_v as _go_v  # Go %v float formatting
from ..io import bed as bedio
from ..io import fasta as fastaio


def selection_mle(in_file: str, out_file: str, *, left: float = -10,
                  right: float = 10, error: float = 1e-5,
                  unpolarized: bool = False,
                  divergence_ascertainment: bool = False,
                  integral_error: float = 1e-7,
                  include_ref: bool = False) -> None:
    data = popgen.vcf_to_afs(
        in_file, unpolarized=unpolarized,
        divergence_ascertainment=divergence_ascertainment,
        include_ref=include_ref)
    answer = popgen.selection_maximum_likelihood_estimate(
        data, left=left, right=right, error=error,
        integral_error=integral_error,
        divergence_ascertainment=divergence_ascertainment)
    with fileio.easy_create(out_file) as out:
        out.write("#FILENAME\tMaximumLikelihood\n")
        out.write(f"{in_file}\t{answer:e}\n")


def selection_mcmc(in_file: str, out_file: str,
                   s: popgen.McmcSettings, set_seed: int = -1) -> None:
    """cmd/selectionMcmc (selectionMcmc.go:17): byte-exact with the
    reference trace goldens via the emulated Go rand stream."""
    from ..numbers.gorand import GoRand

    rng = GoRand(set_seed)
    data = popgen.vcf_to_afs(
        in_file, unpolarized=s.unpolarized,
        divergence_ascertainment=s.divergence_ascertainment,
        include_ref=s.include_ref)
    popgen.metropolis_hastings(data, out_file, s, rng)


def dunn_index(bed_file: str, aln_file: str, group_file: str,
               realign: bool, out_file: str) -> None:
    """cmd/dunnIndex/dunnIndex.go:14."""
    records = bedio.read(bed_file)
    aln = fastaio.read(aln_file)
    groups = popgen.read_groups(group_file)
    for b in records:
        if b.fields_initialized >= 7:
            raise SystemExit("Bed already contains annotation information "
                             "that would be overwritten by dunnIndex.")
        b.fields_initialized = 7
        d, s, missing = popgen.dunn(b, aln, groups, realign)
        b.annotation = [f"{d:f}", str(s), missing]
    bedio.write(out_file, records)


def mcmc_trace_stats(in_file: str, out_file: str,
                     hdi_proportion: float = 0.95, burn_in: int = 0,
                     parameter_name: str = "Mu") -> None:
    """cmd/mcmcTraceStats + numbers/traceMCMC.go."""
    lines = []
    with fileio.easy_open(in_file) as f:
        lines = [ln.rstrip("\n") for ln in f]
    if not lines:
        raise SystemExit("Empty trace file.")
    header = lines[0].split("\t")
    if header[0] != "Iteration":
        raise SystemExit("Improperly formatted MCMC trace file.")
    if parameter_name not in header[1:]:
        raise SystemExit(f"No column with the input parameterName, "
                         f"{parameter_name}, is found in the trace file.")
    col = header.index(parameter_name)
    values = [float(ln.split("\t")[col]) for ln in lines[1:]]
    values = values[burn_in:]
    # plain left-to-right accumulation (numbers.AverageFloat64);
    # python's sum() is Neumaier-compensated since 3.12 and drifts
    total = 0.0
    for v in values:
        total += v
    mean = total / len(values)
    # HighestDensityInterval (traceMCMC.go:70)
    tmp = sorted(values)
    p_index = int(math.ceil(hdi_proportion * len(tmp))) - 1
    start, end = tmp[0], tmp[p_index]
    min_dist = end - start
    for i in range(1, len(tmp) - p_index):
        if tmp[p_index + i] - tmp[i] < min_dist:
            start, end = tmp[i], tmp[p_index + i]
            min_dist = end - start
    with fileio.easy_create(out_file) as out:
        out.write("#FILENAME\tMEAN\tPROPORTION\tSTART\tEND\n")
        out.write(f"{in_file}\t{_go_v(mean)}\t{hdi_proportion:f}\t"
                  f"{start:f}\t{end:f}\n")


def simulate_wright_fisher(out_file: str, *, pop_size: int = 100,
                           mut_rate: float = 1e-1, num_gen: int = 500,
                           genome_size: int = 1, r_fitness: float = 1,
                           gc_content: float = 0.5, init_freq: str = "",
                           fitness_string: str = "", set_seed: int = 1,
                           out_fasta: bool = False) -> None:
    """cmd/simulateWrightFisher (wrightFisherFuncs.go), byte-exact via
    the emulated Go rand stream (draw order: per generation, per site,
    per individual — inheritance draw then mutation-check draw)."""
    from ..numbers.gorand import GoRand
    from .rand_seq import choose_random_base

    rng = GoRand(set_seed)
    if r_fitness < 0:
        raise SystemExit("rFitness value must be greater or equal than "
                         "zero.")
    ancestral = ""
    if init_freq:
        ancestral = init_freq.split(",")[4].upper()
    elif fitness_string:
        ancestral = fitness_string.split(",")[4].upper()
    if init_freq and fitness_string:
        if (init_freq.split(",")[4].upper()
                != fitness_string.split(",")[4].upper()):
            raise SystemExit("Ancestral alleles in -i and -W must be the "
                             "same.")

    from .. import dna

    # initial population (makeInitialPop, wrightFisherFuncs.go:110)
    if not ancestral:
        init_seq = np.array([choose_random_base(rng, gc_content)
                             for _ in range(genome_size)], np.int8)
        pop = np.tile(init_seq, (pop_size, 1))
        ancestral_arr = init_seq.copy()
    else:
        freq = [float(x) for x in init_freq.split(",")[:4]] \
            if init_freq else [0.0, 0.0, 0.0, 0.0]
        if init_freq and sum(freq) != 1.0:
            raise SystemExit("The sum of initial frequencies must be 1")
        pop = np.zeros((pop_size, genome_size), dtype=np.int8)
        anc_code = int(dna.from_string(ancestral)[0])
        if init_freq:
            for j in range(pop_size):
                ratio = (j + 1) / pop_size
                if ratio <= freq[0]:
                    pop[j, :] = 0
                elif ratio <= freq[0] + freq[1]:
                    pop[j, :] = 1
                elif ratio <= freq[0] + freq[1] + freq[2]:
                    pop[j, :] = 2
                else:
                    pop[j, :] = 3
        else:
            pop[:, :] = anc_code
        ancestral_arr = np.full(genome_size, anc_code, dtype=np.int8)

    # fitness landscape per site x base (makeFitnessArray)
    if fitness_string:
        fit_vals = [float(x) for x in fitness_string.split(",")[:4]]
        if any(f < 0 for f in fit_vals):
            raise SystemExit("Relative fitness values must be greater or "
                             "equal than zero.")
        rel_fit = [list(fit_vals) for _ in range(genome_size)]
    else:
        rel_fit = [[1.0 if b == int(ancestral_arr[sx]) else r_fitness
                    for b in range(4)] for sx in range(genome_size)]

    def site_freqs(p, sx):
        col = p[:, sx]
        n = float(pop_size)
        return [float((col == b).sum()) / n for b in range(4)]

    freqs = np.zeros((num_gen + 1, genome_size, 4))
    for sx in range(genome_size):
        freqs[0, sx] = site_freqs(pop, sx)
    norm = [freqs[0, sx, 0] * rel_fit[sx][0]
            + freqs[0, sx, 1] * rel_fit[sx][1]
            + freqs[0, sx, 2] * rel_fit[sx][2]
            + freqs[0, sx, 3] * rel_fit[sx][3]
            for sx in range(genome_size)]

    def mutate_base(orig):
        new = choose_random_base(rng, gc_content)
        while new == orig:
            new = choose_random_base(rng, gc_content)
        return new

    cur = pop
    nxt = pop.copy()
    for t in range(1, num_gen + 1):
        for sx in range(genome_size):
            f0 = freqs[t - 1, sx, 0] * rel_fit[sx][0] / norm[sx]
            f1 = freqs[t - 1, sx, 1] * rel_fit[sx][1] / norm[sx]
            f2 = freqs[t - 1, sx, 2] * rel_fit[sx][2] / norm[sx]
            f3 = freqs[t - 1, sx, 3] * rel_fit[sx][3] / norm[sx]
            c01 = f0 + f1
            c012 = f0 + f1 + f2
            for pp in range(pop_size):
                r = rng.float64()
                if r < f0:
                    b = 0
                elif r < c01:
                    b = 1
                elif r < c012:
                    b = 2
                else:
                    b = 3
                if rng.float64() < mut_rate:
                    b = mutate_base(b)
                nxt[pp, sx] = b
        cur, nxt = nxt, cur
        for sx in range(genome_size):
            freqs[t, sx] = site_freqs(cur, sx)
        norm = [freqs[t, sx, 0] * rel_fit[sx][0]
                + freqs[t, sx, 1] * rel_fit[sx][1]
                + freqs[t, sx, 2] * rel_fit[sx][2]
                + freqs[t, sx, 3] * rel_fit[sx][3]
                for sx in range(genome_size)]
    pop = cur

    if out_fasta:
        fastaio.write(out_file,
                      [fastaio.Fasta(f"Seq_{i}", pop[i].copy())
                       for i in range(pop_size)])
        return
    mut_str = f"{mut_rate:.3g}"
    if "e" in mut_str and "e-" in mut_str:
        mant, exp = mut_str.split("e-")
        mut_str = f"{mant}e-{int(exp):02d}"
    with fileio.easy_create(out_file) as out:
        out.write(f"##PopulationSize={pop_size}:"
                  f"NumGeneration={num_gen}:Replicates={genome_size}:"
                  f"MutationRate={mut_str}:"
                  f"RelativeFitness={r_fitness:.5f}\n")
        out.write("Gen\tSite\tFreq.A\tFreq.C\tFreq.G\tFreq.T\t"
                  "Ancestral\n")
        for t in range(num_gen + 1):
            for s_idx in range(genome_size):
                anc = dna.to_string(ancestral_arr[s_idx:s_idx + 1])
                out.write(f"{t}\t{s_idx}\t"
                          + "\t".join(f"{freqs[t, s_idx, b]:.5f}"
                                      for b in range(4))
                          + f"\t{anc}\n")


def main_mle(argv=None) -> None:
    p = argparse.ArgumentParser(prog="selectionMle")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-leftBound", type=float, default=-10)
    p.add_argument("-rightBound", type=float, default=10)
    p.add_argument("-errorThreshold", type=float, default=1e-5)
    p.add_argument("-unPolarized", action="store_true")
    p.add_argument("-divergenceAscertainment", action="store_true")
    p.add_argument("-integralError", type=float, default=1e-7)
    p.add_argument("-includeRef", action="store_true")
    a = p.parse_args(argv)
    selection_mle(a.input, a.output, left=a.leftBound, right=a.rightBound,
                  error=a.errorThreshold, unpolarized=a.unPolarized,
                  divergence_ascertainment=a.divergenceAscertainment,
                  integral_error=a.integralError,
                  include_ref=a.includeRef)


def main_mcmc(argv=None) -> None:
    p = argparse.ArgumentParser(prog="selectionMcmc")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-iterations", type=int, default=100)
    p.add_argument("-muStep", type=float, default=0.2)
    p.add_argument("-muZero", type=float, default=0.0)
    p.add_argument("-sigmaStep", type=float, default=0.1)
    p.add_argument("-sigmaZero", type=float, default=0.1)
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-unPolarized", action="store_true")
    p.add_argument("-divergenceAscertainment", action="store_true")
    p.add_argument("-fixedSigma", action="store_true")
    p.add_argument("-integralError", type=float, default=1e-7)
    p.add_argument("-includeRef", action="store_true")
    a = p.parse_args(argv)
    s = popgen.McmcSettings(
        iterations=a.iterations, mu_step=a.muStep, mu_zero=a.muZero,
        sigma_step=a.sigmaStep, sigma_zero=a.sigmaZero,
        unpolarized=a.unPolarized,
        divergence_ascertainment=a.divergenceAscertainment,
        fixed_sigma=a.fixedSigma, integral_error=a.integralError,
        include_ref=a.includeRef)
    selection_mcmc(a.input, a.output, s, a.setSeed)


def main_dunn(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dunnIndex")
    p.add_argument("bed")
    p.add_argument("aln")
    p.add_argument("groups")
    p.add_argument("output")
    p.add_argument("-realign", action="store_true")
    a = p.parse_args(argv)
    dunn_index(a.bed, a.aln, a.groups, a.realign, a.output)


def main_trace_stats(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mcmcTraceStats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-hdiProportion", type=float, default=0.95)
    p.add_argument("-burnIn", type=int, default=0)
    p.add_argument("-parameterName", default="Mu")
    a = p.parse_args(argv)
    mcmc_trace_stats(a.input, a.output, a.hdiProportion, a.burnIn,
                     a.parameterName)


def main_wright_fisher(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateWrightFisher")
    p.add_argument("output")
    p.add_argument("-N", type=int, default=100)
    p.add_argument("-m", type=float, default=1e-1)
    p.add_argument("-t", type=int, default=500)
    p.add_argument("-g", type=int, default=1)
    p.add_argument("-w", type=float, default=1)
    p.add_argument("-gc", type=float, default=0.5)
    p.add_argument("-i", default="")
    p.add_argument("-W", default="")
    p.add_argument("-setSeed", type=int, default=1)
    p.add_argument("-f", action="store_true")
    a = p.parse_args(argv)
    simulate_wright_fisher(a.output, pop_size=a.N, mut_rate=a.m,
                           num_gen=a.t, genome_size=a.g, r_fitness=a.w,
                           gc_content=a.gc, init_freq=a.i,
                           fitness_string=a.W, set_seed=a.setSeed,
                           out_fasta=a.f)
