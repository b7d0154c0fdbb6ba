"""ilsReconstructSeq: the reconstructions of several topologies
averaged base by base, each weighted by its topology's posterior
probability at that position, a copy of
``gonomics_tpu/cli/ils_reconstruct_seq.py`` (37 lines, whole), gonomics'
``cmd/ilsReconstructSeq``.

    gonomics-torch ilsReconstructSeq [--precision 0.001] post_probs.list
        recons.list chrom.sizes out.pfa

post_probs.list names a wig a topology, recons.list a ``.pfa`` a
topology (its first record, whose name is the wig's chrom). The weights
at each position must sum to 1 within --precision; the output is one
``.pfa`` record, ``ilsRecon``.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import pfasta
from ..io import wig as wigio
from ..phylo.reconstruct import ils_reconstruct_seq


def ils_reconstruct_seq_cmd(post_probs_files: str, recon_files: str,
                            chrom_sizes_file: str, out_file: str, *,
                            precision: float = 0.001) -> None:
    recons = [pfasta.read(path)[0] for path in fileio.read(recon_files)]
    post_probs = [wigio.read(path, chrom_sizes_file, 0)
                  for path in fileio.read(post_probs_files)]
    out = ils_reconstruct_seq(post_probs, recons, precision)
    pfasta.write(out_file, [out])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ilsReconstructSeq")
    p.add_argument("--precision", type=float, default=0.001)
    p.add_argument("postProbs")
    p.add_argument("recons")
    p.add_argument("chromSizes")
    p.add_argument("outDir")
    a = p.parse_args(argv)
    ils_reconstruct_seq_cmd(a.postProbs, a.recons, a.chromSizes, a.outDir,
                            precision=a.precision)


if __name__ == "__main__":
    main()
