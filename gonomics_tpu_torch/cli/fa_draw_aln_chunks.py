"""faDrawAlnChunks: a chunk alignment drawn to PNG; a copy of
``gonomics_tpu/cli/fa_draw_aln_chunks.py`` (30 lines, whole), gonomics'
``cmd/faDrawAlnChunks``. Needs PIL."""

from __future__ import annotations

import argparse

from ..align.draw import draw_aligned_chunks
from ..io import fasta as fastaio


def fa_draw_aln_chunks(fa_aln_file: str, chunk_size: int,
                       image_out_file: str) -> None:
    """cmd/faDrawAlnChunks/faDrawAlnChunks.go:19-29: 6x12 px chunks."""
    aln = fastaio.read(fa_aln_file)
    img = draw_aligned_chunks(aln, chunk_size, 6, 12)
    img.save(image_out_file, "PNG")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faDrawAlnChunks")
    p.add_argument("input")
    p.add_argument("chunkSize", type=int)
    p.add_argument("output")
    a = p.parse_args(argv)
    fa_draw_aln_chunks(a.input, a.chunkSize, a.output)


if __name__ == "__main__":
    main()
