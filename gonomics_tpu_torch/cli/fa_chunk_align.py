"""faChunkAlign: progressive alignment in chunks of bases; a copy of
``gonomics_tpu/cli/fa_chunk_align.py`` (37 lines, whole), gonomics'
``cmd/faChunkAlign``. The chunk DP runs on the host, as in the JAX."""

from __future__ import annotations

import argparse

from ..align import matrices
from ..align.multi import all_seq_affine_chunk
from ..io import fasta as fastaio


def fa_chunk_align(in_file: str, chunk_size: int, gap_open: int,
                   gap_extend: int, out_file: str) -> None:
    """cmd/faChunkAlign/faChunkAlign.go:18-29: HumanChimpTwo matrix,
    penalties negated from the flag values."""
    records = fastaio.read(in_file)
    records = all_seq_affine_chunk(records, matrices.HUMAN_CHIMP_TWO,
                                   gap_open, gap_extend, chunk_size)
    fastaio.write(out_file, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faChunkAlign")
    p.add_argument("-gapOpen", type=int, default=300,
                   help="Penalty for opening a gap")
    p.add_argument("-gapExtend", type=int, default=40,
                   help="Penalty for extending a gap")
    p.add_argument("input")
    p.add_argument("chunkSize", type=int)
    p.add_argument("output")
    a = p.parse_args(argv)
    fa_chunk_align(a.input, a.chunkSize, -a.gapOpen, -a.gapExtend, a.output)


if __name__ == "__main__":
    main()
