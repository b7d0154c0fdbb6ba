"""girafSimulate: simulated giraf alignments from a genome graph; a
copy of ``gonomics_tpu/cli/giraf_simulate.py`` (42 lines, whole),
gonomics' ``cmdx/girafSimulate``. The reads and the somatic SNVs each
draw from a fresh ``GoRand(seed)`` (``graph.rand_giraf``,
``graph.rand_somatic_mutations``)."""

from __future__ import annotations

import argparse
import sys

from .. import graph as graphmod
from ..io import giraf as girafio


def giraf_simulate(graph_file: str, out_file: str, *, num_reads: int = 100,
                   read_len: int = 150, seed: int = 0,
                   num_somatic_snv: int = 0,
                   allele_frequency: float = 0.2) -> None:
    g = graphmod.read(graph_file)
    reads = graphmod.rand_giraf(g, num_reads, read_len, seed)
    if num_somatic_snv != 0:
        graphmod.rand_somatic_mutations(g, reads, num_somatic_snv,
                                        allele_frequency, seed)
    girafio.write(out_file, reads)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="girafSimulate")
    p.add_argument("graph")
    p.add_argument("out")
    p.add_argument("-numReads", type=int, default=100)
    p.add_argument("-readLen", type=int, default=150)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-somaticSNV", type=int, default=0)
    p.add_argument("-somaticAF", type=float, default=0.2)
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    giraf_simulate(a.graph, a.out, num_reads=a.numReads,
                   read_len=a.readLen, seed=a.seed,
                   num_somatic_snv=a.somaticSNV,
                   allele_frequency=a.somaticAF)


if __name__ == "__main__":
    main()
