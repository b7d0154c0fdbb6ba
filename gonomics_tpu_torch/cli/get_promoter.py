"""getPromoter: promoter windows of a gene list as bed; a copy of
``gonomics_tpu/cli/get_promoter.py`` (38 lines, whole), gonomics'
``cmd/getPromoter``.

    gonomics-torch getPromoter genes.txt in.gtf out.bed chrom.sizes
        [-upstream 1000] [-downstream 200]

Every transcript of every gene of each listed name gives a window
(``gtf.find_promoter``: on the minus strand around the transcript's
start), clipped at 0 and at the chrom's size.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio
from ..io import chrom_info
from ..io import gtf as gtfio


def get_promoter(genes_file: str, gtf_file: str, out_bed: str,
                 chrom_file: str, upstream: int = 1000,
                 downstream: int = 200) -> None:
    names = list(fileio.read(genes_file))
    genes = gtfio.read(gtf_file)
    sizes = chrom_info.read_to_map(chrom_file)
    bedio.write(out_bed, gtfio.find_promoter(names, upstream, downstream,
                                             genes, sizes))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="getPromoter")
    p.add_argument("uniqueGenes")
    p.add_argument("gtf")
    p.add_argument("output")
    p.add_argument("chromSizes")
    p.add_argument("-upstream", type=int, default=1000)
    p.add_argument("-downstream", type=int, default=200)
    a = p.parse_args(argv)
    get_promoter(a.uniqueGenes, a.gtf, a.output, a.chromSizes,
                 a.upstream, a.downstream)


if __name__ == "__main__":
    main()
