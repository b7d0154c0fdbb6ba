"""statCalc: densities, integrals, tail sums and samples of the common
distributions, a copy of ``gonomics_tpu/cli/stat_calc.py`` (147 lines,
whole), gonomics' ``cmd/statCalc/statCalc.go``, its flags, defaults and
error texts unchanged.

    gonomics-torch statCalc [-normal mu,sigma | -binomial n,p |
        -poisson lambda | -beta a,b | -gamma a,b] x [y]
    gonomics-torch statCalc -sampleAfs alpha,n,depth,bins,left,right
        | -sampleBeta a,b,n | -sampleGamma a,b,n | -sampleNormal mu,sigma,n
        [-setSeed s] [-outFile f]

One value a line in Go's ``%e``. The samplers draw from numpy's
``default_rng(seed)`` on the host, as the JAX tool does (unseeded with
``-setSeed -1``); ``-sampleAfs`` runs ``distributions``' rejection
sampler on ``popgen.afs_stationarity``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import fileio, popgen
from ..numbers import distributions as dist


def _fmt(x: float) -> str:
    return f"{x:e}"


def stat_calc(args: list[str], *, normal="", binomial="", poisson="",
              beta="", gamma="", sample_afs="", sample_beta="",
              sample_gamma="", sample_normal="", seed=-1,
              out_file="stdout") -> None:
    chosen = [x for x in (normal, binomial, poisson, beta, gamma,
                          sample_afs, sample_beta, sample_gamma,
                          sample_normal) if x]
    if len(chosen) > 1:
        raise SystemExit("Error: Multiple distribution arguments selected.")
    rng = np.random.default_rng(seed if seed >= 0 else None)
    out = sys.stdout if out_file == "stdout" else fileio.easy_create(out_file)
    lines: list[str] = []
    if normal:
        mu, sigma = (float(x) for x in normal.split(","))
        if len(args) == 1:
            lines.append(_fmt(dist.normal_dist(float(args[0]), mu, sigma)))
        elif len(args) == 2:
            lines.append(_fmt(dist.normal_adaptive_integral(
                args[0], args[1], mu, sigma)))
        else:
            raise SystemExit("expected one or two arguments")
    elif binomial:
        w = binomial.split(",")
        n, p = int(w[0]), float(w[1])
        if len(args) == 1:
            lines.append(_fmt(dist.binomial_dist(n, int(args[0]), p)))
        elif len(args) == 2:
            left = int(args[0])
            if args[1] in ("N", "n"):
                lines.append(_fmt(1.0 if left == 0
                                  else dist.binomial_right_summation(
                                      n, left, p)))
            elif left == 0:
                lines.append(_fmt(dist.binomial_left_summation(
                    n, int(args[1]), p)))
            else:
                lines.append(_fmt(dist.binomial_sum(left, int(args[1]),
                                                    n, p)))
        else:
            raise SystemExit("expected one or two arguments")
    elif poisson:
        lam = float(poisson)
        if len(args) == 1:
            lines.append(_fmt(dist.poisson_dist(int(args[0]), lam)))
        elif len(args) == 2:
            if args[1] in ("INF", "inf", "Inf"):
                lines.append(_fmt(dist.poisson_right_summation(
                    int(args[0]), lam)))
            else:
                lines.append(_fmt(dist.poisson_sum(int(args[0]),
                                                   int(args[1]), lam)))
        else:
            raise SystemExit("expected one or two arguments")
    elif beta:
        a, b = (float(x) for x in beta.split(","))
        if len(args) == 1:
            lines.append(_fmt(dist.beta_dist(float(args[0]), a, b)))
        elif len(args) == 2:
            lines.append(_fmt(dist.beta_integral(float(args[0]),
                                                 float(args[1]), a, b)))
        else:
            raise SystemExit("expected one or two arguments")
    elif gamma:
        a, b = (float(x) for x in gamma.split(","))
        if len(args) == 1:
            lines.append(_fmt(dist.gamma_dist(float(args[0]), a, b)))
        elif len(args) == 2:
            if args[1] in ("INF", "inf", "Inf"):
                lines.append(_fmt(dist.gamma_right_integral(
                    float(args[0]), a, b)))
            else:
                lines.append(_fmt(dist.gamma_integral(
                    float(args[0]), float(args[1]), a, b)))
        else:
            raise SystemExit("expected one or two arguments")
    elif sample_afs:
        w = sample_afs.split(",")
        alpha, n_samples, depth, bins = (float(w[0]), int(w[1]), int(w[2]),
                                         int(w[3]))
        x_left, x_right = float(w[4]), float(w[5])
        vals = dist.fast_rejection_sampler(
            x_left, x_right, lambda p: popgen.afs_stationarity(p, alpha),
            bins, depth, n_samples, rng)
        lines.extend(_fmt(v) for v in vals)
    elif sample_beta:
        a, b, n_samples = sample_beta.split(",")
        lines.extend(_fmt(v) for v in
                     rng.beta(float(a), float(b), int(n_samples)))
    elif sample_gamma:
        a, b, n_samples = sample_gamma.split(",")
        # reference RandGamma is shape/rate parameterized
        lines.extend(_fmt(v) for v in
                     rng.gamma(float(a), 1.0 / float(b), int(n_samples)))
    elif sample_normal:
        mu, sigma, n_samples = sample_normal.split(",")
        lines.extend(_fmt(v) for v in
                     rng.normal(float(mu), float(sigma), int(n_samples)))
    else:
        raise SystemExit("Error: No distribution command specified.")
    for ln in lines:
        out.write(ln + "\n")
    if out is not sys.stdout:
        out.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="statCalc")
    p.add_argument("args", nargs="*")
    p.add_argument("-normal", default="")
    p.add_argument("-binomial", default="")
    p.add_argument("-poisson", default="")
    p.add_argument("-beta", default="")
    p.add_argument("-gamma", default="")
    p.add_argument("-sampleAfs", default="")
    p.add_argument("-sampleBeta", default="")
    p.add_argument("-sampleGamma", default="")
    p.add_argument("-sampleNormal", default="")
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-outFile", default="stdout")
    a = p.parse_args(argv)
    stat_calc(a.args, normal=a.normal, binomial=a.binomial,
              poisson=a.poisson, beta=a.beta, gamma=a.gamma,
              sample_afs=a.sampleAfs, sample_beta=a.sampleBeta,
              sample_gamma=a.sampleGamma, sample_normal=a.sampleNormal,
              seed=a.setSeed, out_file=a.outFile)


if __name__ == "__main__":
    main()
