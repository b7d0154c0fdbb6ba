"""plotFunctions: tab-separated evaluations of a function for plotting,
a copy of ``gonomics_tpu/cli/plot_functions.py`` (190 lines, whole),
gonomics' ``cmd/plotFunctions/plotFunctions.go`` with ``numbers.Plot``
(numbers/plot.go:12-41) and popgen's plots (popgen/plot.go:12-165), its
arguments and error texts unchanged.

    gonomics-torch plotFunctions AfsStationarity|Beta|Gamma|Normal
        params left right bins out.txt
    gonomics-torch plotFunctions AfsF|AfsProbability[Ancestral|Derived]
        alpha,n,integralError out.txt
    gonomics-torch plotFunctions ChooseN n out.txt
    gonomics-torch plotFunctions AscertainmentProbability{Derived,Ancestral}
        n,d out.txt
    gonomics-torch plotFunctions {Ancestral,Derived}AscertainmentDenominator
        n,d,alpha,integralError out.txt
"""

from __future__ import annotations

import argparse
import sys

from .. import fileio, popgen
from ..numbers import binom_coefficient_log
from ..numbers import distributions as dist


def plot(f, left: float, right: float, bins: int, out_file: str) -> None:
    """numbers.Plot (plot.go:12): X\tf(X) rows with Go %f formatting."""
    with fileio.easy_create(out_file) as out:
        step = (right - left) / bins
        current = left
        out.write("X\tf(X)\n")
        for _ in range(bins):
            out.write(f"{current:f}\t{f(current):f}\n")
            current += step


def plot_binom_coefficient(n: int, out_file: str) -> None:
    """numbers.PlotBinomCoefficient (plot.go:27)."""
    with fileio.easy_create(out_file) as out:
        out.write("i\tProbability\n")
        for i in range(1, n):
            out.write(f"{i}\t{fileio.go_v(binom_coefficient_log(n, i))}\n")


def plot_afs_f(alpha: float, n: int, out_file: str,
               integral_error: float) -> None:
    """popgen.PlotAfsF (plot.go:12)."""
    cache = popgen.build_binom_cache([n])
    with fileio.easy_create(out_file) as out:
        out.write("Frequency\tF\n")
        for i in range(1, n):
            v = popgen.afs_sample_density(n, i, alpha, cache, integral_error)
            out.write(f"{i}\t{v:e}\n")


def plot_afs_pmf(alpha: float, n: int, out_file: str, integral_error: float,
                 derived: bool, ancestral: bool) -> None:
    """popgen.PlotAfsPmf (plot.go:31)."""
    if derived and ancestral:
        raise SystemExit("PlotAfsPmf cannot be used with both the derived "
                         "and ancestral correction simultaneously.")
    cache = popgen.build_binom_cache([n])
    with fileio.easy_create(out_file) as out:
        out.write("Frequency\tProbability\n")
        for i in range(1, n):
            if ancestral:
                v = popgen.\
                    allele_frequency_probability_ancestral_ascertainment(
                        alpha, i, n, 1, cache, integral_error)
            elif derived:
                v = popgen.\
                    allele_frequency_probability_derived_ascertainment(
                        alpha, i, n, 1, cache, integral_error)
            else:
                v = popgen.allele_frequency_probability(
                    i, n, alpha, cache, integral_error)
            out.write(f"{i}\t{v:e}\n")


def plot_ascertainment_probability(out_file: str, n: int, d: int,
                                   derived: bool) -> None:
    """popgen.Plot{Derived,Ancestral}AscertainmentProbability
    (plot.go:91,108)."""
    fn = (popgen.derived_ascertainment_probability if derived
          else popgen.ancestral_ascertainment_probability)
    with fileio.easy_create(out_file) as out:
        out.write("Frequency\tProbability\n")
        for i in range(1, n):
            out.write(f"{i}\t{fn(n, i, d):e}\n")


def plot_ascertainment_denominator(out_file: str, n: int, d: int,
                                   alpha: float, integral_error: float,
                                   derived: bool) -> None:
    """popgen.Plot{Derived,Ancestral}AscertainmentDenominator
    (plot.go:125,147)."""
    cache = popgen.build_binom_cache([n])
    f_cache = popgen.build_f_cache(n, alpha, cache, integral_error)
    f_sum = popgen.get_f_cache_sum(f_cache)
    fn = (popgen.derived_ascertainment_denominator if derived
          else popgen.ancestral_ascertainment_denominator)
    with fileio.easy_create(out_file) as out:
        out.write("Frequency\tProbability\n")
        for i in range(1, n):
            out.write(f"{i}\t{fn(f_cache, f_sum, d):e}\n")


def plot_continuous_functions(function: str, function_args: str,
                              left: float, right: float, bins: int,
                              out_file: str) -> None:
    """plotContinuousFunctions (plotFunctions.go:17)."""
    words = function_args.split(",")
    if function == "AfsStationarity":
        if len(words) != 1:
            raise SystemExit("A stationarity distribution is defined by "
                             f"one parameter, received {len(words)}.")
        alpha = float(words[0])
        plot(lambda p: popgen.afs_stationarity(p, alpha),
             left, right, bins, out_file)
    elif function == "Beta":
        if len(words) != 2:
            raise SystemExit("A beta distribution is defined by two "
                             f"parameters, received {len(words)}.")
        a, b = float(words[0]), float(words[1])
        plot(lambda x: dist.beta_dist(x, a, b), left, right, bins, out_file)
    elif function == "Gamma":
        if len(words) != 2:
            raise SystemExit("A gamma distribution is defined by two "
                             f"parameters, received {len(words)}.")
        a, b = float(words[0]), float(words[1])
        plot(lambda x: dist.gamma_dist(x, a, b), left, right, bins, out_file)
    elif function == "Normal":
        if len(words) != 2:
            raise SystemExit("a normal distribution is defined by two "
                             f"parameters, received {len(words)}.")
        mu, sigma = float(words[0]), float(words[1])
        plot(lambda x: dist.normal_dist(x, mu, sigma),
             left, right, bins, out_file)
    else:
        raise SystemExit(f"Unrecognized function: {function}.")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="plotFunctions")
    p.add_argument("args", nargs="+")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    args = a.args
    kind = args[0]

    def need(want: int):
        # the reference errors on wrong arg counts before indexing
        # (plotFunctions.go usage checks); avoid a raw IndexError here
        if len(args) != want:
            raise SystemExit(f"Error: {kind} expects {want} arguments, "
                             f"but got {len(args)}")

    def split3(spec, want):
        words = spec.split(",")
        if len(words) != want:
            raise SystemExit(f"expected {want} parameters, "
                             f"received {len(words)}")
        return words

    if kind in ("AfsProbability", "AfsProbabilityAncestral",
                "AfsProbabilityDerived"):
        need(3)
        w = split3(args[1], 3)
        plot_afs_pmf(float(w[0]), int(w[1]), args[2], float(w[2]),
                     derived=kind.endswith("Derived"),
                     ancestral=kind.endswith("Ancestral"))
    elif kind in ("AscertainmentProbabilityDerived",
                  "AscertainmentProbabilityAncestral"):
        need(3)
        w = split3(args[1], 2)
        plot_ascertainment_probability(args[2], int(w[0]), int(w[1]),
                                       derived=kind.endswith("Derived"))
    elif kind in ("AncestralAscertainmentDenominator",
                  "DerivedAscertainmentDenominator"):
        need(3)
        w = split3(args[1], 4)
        plot_ascertainment_denominator(
            args[2], int(w[0]), int(w[1]), float(w[2]), float(w[3]),
            derived=kind.startswith("Derived"))
    elif kind == "ChooseN":
        need(3)
        plot_binom_coefficient(int(args[1]), args[2])
    elif kind == "AfsF":
        need(3)
        w = split3(args[1], 3)
        plot_afs_f(float(w[0]), int(w[1]), args[2], float(w[2]))
    else:
        if len(args) != 6:
            raise SystemExit(f"Error: expecting 6 arguments, "
                             f"but got {len(args)}")
        plot_continuous_functions(args[0], args[1], float(args[2]),
                                  float(args[3]), int(args[4]), args[5])


if __name__ == "__main__":
    main()
