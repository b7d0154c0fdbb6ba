"""simulateSam: simulated Illumina read pairs as SAM or BAM, a copy of
``gonomics_tpu/cli/simulate_sam.py`` (44 lines), gonomics'
``cmd/simulateSam/simulateSam.go``, its flags, defaults and exit
messages unchanged.

    gonomics-torch simulateSam ref.fa out.sam|out.bam (-n pairs |
        -coverage c) [-setSeed 1] [-readLength 150] [-fragmentLength 400]
        [-fragmentStdDev 50] [-flatErrorRate 0] [-ancientErrorRate 0]
        [-geometricParam 0.25] [-deaminationDistribution d.txt]

Every draw comes from the emulated Go rand stream (``numbers/gorand``),
so the output is the JAX tool's bytes and gonomics' own. ``-coverage c``
makes ``int(c * total / (2 * readLength))`` pairs.
"""

from __future__ import annotations

import argparse

from ..simulate import simulate_sam


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateSam")
    p.add_argument("ref")
    p.add_argument("out")
    p.add_argument("-n", type=int, default=0,
                   help="number of read pairs to generate")
    p.add_argument("-coverage", type=float, default=0.0)
    p.add_argument("-setSeed", type=int, default=1)
    p.add_argument("-readLength", type=int, default=150)
    p.add_argument("-fragmentLength", type=int, default=400)
    p.add_argument("-fragmentStdDev", type=float, default=50.0)
    p.add_argument("-flatErrorRate", type=float, default=0.0)
    p.add_argument("-geometricParam", type=float, default=0.25)
    p.add_argument("-ancientErrorRate", type=float, default=0.0)
    p.add_argument("-deaminationDistribution", default="")
    a = p.parse_args(argv)
    if a.coverage < 0:
        raise SystemExit("Error: coverage must be a value greater than 0.")
    if a.n < 1 and a.coverage <= 0:
        raise SystemExit("Error: number of reads must be greater than 0.")
    if a.coverage > 0 and a.n > 0:
        raise SystemExit("Error: specify either -coverage or -n, not both.")
    simulate_sam(a.ref, a.out, num_reads=a.n, coverage=a.coverage,
                 read_len=a.readLength, flat_error_rate=a.flatErrorRate,
                 fragment_length=a.fragmentLength,
                 fragment_std=a.fragmentStdDev,
                 ancient_error_rate=a.ancientErrorRate,
                 geometric_param=a.geometricParam, set_seed=a.setSeed,
                 deamination_distribution=a.deaminationDistribution)


if __name__ == "__main__":
    main()
