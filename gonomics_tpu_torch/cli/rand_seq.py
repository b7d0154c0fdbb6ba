"""randSeq: pseudorandom DNA FASTA, a copy of
``gonomics_tpu/cli/rand_seq.py`` (59 lines), gonomics'
``cmd/randSeq/randSeq.go`` with ``simulate.RandIntergenicSeq``
(withIndels.go:19), its flags and defaults unchanged.

    gonomics-torch randSeq out.fa [-GC 0.41] [-numSeq 10] [-lenSeq 500]
        [-setSeed -1]

Bases are drawn from the emulated Go rand stream (``numbers/gorand``),
one ``Float64`` each in gonomics' order, and the stream runs on across
records; records are ``Sequence_0``, ``Sequence_1``, ... at 50 bases a
line. ``-setSeed 1 -numSeq 1 -lenSeq 10`` writes ``TATTTTGGGC``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import fileio
from ..io import fasta as fastaio
from ..numbers.gorand import GoRand


def choose_random_base(rng: GoRand, gc_content: float) -> int:
    """simulate.ChooseRandomBase (simulate.go:110): one Float64 draw;
    branch order G, C, T, A."""
    at = 1 - gc_content
    r = rng.float64()
    if r < gc_content / 2:
        return 2  # G
    if r < gc_content:
        return 1  # C
    if r < at / 2 + gc_content:
        return 3  # T
    return 0      # A


def rand_intergenic_seq(rng: GoRand, gc: float, length: int) -> np.ndarray:
    """simulate.RandIntergenicSeq (withIndels.go:19)."""
    return np.array([choose_random_base(rng, gc) for _ in range(length)],
                    np.int8)


def rand_seq(out_file: str, gc: float = 0.41, num_seq: int = 10,
             len_seq: int = 500, set_seed: int = -1) -> None:
    rng = GoRand(set_seed)
    with fileio.easy_create(out_file) as f:
        for i in range(num_seq):
            fastaio.write_fasta(
                f, fastaio.Fasta(f"Sequence_{i}",
                                 rand_intergenic_seq(rng, gc, len_seq)), 50)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="randSeq")
    p.add_argument("output")
    p.add_argument("-GC", type=float, default=0.41)
    p.add_argument("-numSeq", type=int, default=10)
    p.add_argument("-lenSeq", type=int, default=500)
    p.add_argument("-setSeed", type=int, default=-1)
    a = p.parse_args(argv)
    rand_seq(a.output, a.GC, a.numSeq, a.lenSeq, a.setSeed)


if __name__ == "__main__":
    main()
