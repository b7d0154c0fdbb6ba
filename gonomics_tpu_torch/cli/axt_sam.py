"""axtSam: axt alignments as SAM records; a copy of
``gonomics_tpu/cli/axt_sam.py`` (39 lines, whole), gonomics'
``cmd/axtSam``.

    gonomics-torch axtSam [--chrom t.sizes | --fasta t.fa] in.axt out.sam

The header's @SQ lines come from --chrom, else from --fasta, else the
header is empty. An output ending ``.bam`` is written as BAM.
"""

from __future__ import annotations

import argparse

from ..io import chrom_info
from ..io import fasta as fastaio
from ..io import formats
from ..io import sam as samio


def axt_sam(in_file: str, out_file: str, *, chrom_sizes: str = "",
            fa_file: str = "") -> None:
    if chrom_sizes:
        header = samio.generate_header(chrom_info.read_to_slice(chrom_sizes))
    elif fa_file:
        chroms = [chrom_info.ChromInfo(r.name, len(r.seq), i)
                  for i, r in enumerate(fastaio.read(fa_file))]
        header = samio.generate_header(chroms)
    else:
        header = samio.Header()
    records = [formats.axt_to_sam(a) for a in formats.read_axt(in_file)]
    samio.write_sam(out_file, header, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="axtSam")
    p.add_argument("--chrom", default="")
    p.add_argument("--fasta", default="")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    axt_sam(a.input, a.output, chrom_sizes=a.chrom, fa_file=a.fasta)


if __name__ == "__main__":
    main()
