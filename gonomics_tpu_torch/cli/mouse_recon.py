"""mouseRecon: the Mouse-Rat ancestor ("mra") of a
Mouse-Rat-Hamster-Squirrel multiFa, a copy of
``gonomics_tpu/cli/mouse_recon.py`` (65 lines, whole), its flags and
defaults unchanged; deprecated in the reference in favour of
reconstructSeq and kept for its command line.

    gonomics-torch mouseRecon -mleTree tree.nh in.fa out.fa
        [-probThreshold 0] [-nonBiasProbThreshold 0]

The Felsenstein marginals at "mra", called with a bias to the mouse base
(likelihoodToBaseBias, mouseRecon.go:89-114), which is primateRecon's
biased caller; so this module imports primateRecon's.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import fasta as fastaio
from ..phylo.etree import read_tree
from .primate_recon import (_find, base_is_present, call_bases_bias,
                            node_likelihoods)


def mra_is_present(mouse, rat, hamster, squirrel) -> np.ndarray:
    """mraIsPresent (mouseRecon.go:61-69), vectorized."""
    m, r, h, s = map(base_is_present, (mouse, rat, hamster, squirrel))
    return (m & r) | ((m | r) & (h | s))


def mouse_recon_mra_mle(in_fa: str, out_fa: str, tree_file: str,
                        prob_threshold: float,
                        non_bias_prob_threshold: float) -> None:
    """mouseReconMraMle (mouseRecon.go:19-59)."""
    root = read_tree(tree_file, in_fa)
    mouse = _find(root, "mm10")
    rat = _find(root, "rn7")
    hamster = _find(root, "criGriChoV2")
    squirrel = _find(root, "speTri2")
    fix, mra = node_likelihoods(root, "mra")
    present = mra_is_present(mouse.fasta.seq, rat.fasta.seq,
                             hamster.fasta.seq, squirrel.fasta.seq)
    calls = call_bases_bias(fix, np.asarray(mouse.fasta.seq, np.int8),
                            prob_threshold, non_bias_prob_threshold)
    mra.fasta.seq = np.where(present, calls, dna.GAP).astype(np.int8)
    fastaio.write(out_fa, [mouse.fasta, rat.fasta, hamster.fasta,
                           squirrel.fasta, mra.fasta])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="mouseRecon",
        description="[DEPRECATED — use reconstructSeq] Returns maximum "
                    "likelihood ancestral sequences from a Mouse-Rat-"
                    "ChineseHamster-Squirrel multiFa alignment")
    p.add_argument("-mleTree", default="",
                   help="newick tree with branch lengths")
    p.add_argument("-probThreshold", type=float, default=0.0)
    p.add_argument("-nonBiasProbThreshold", type=float, default=0.0)
    p.add_argument("inFile")
    p.add_argument("outFile")
    a = p.parse_args(argv)
    mouse_recon_mra_mle(a.inFile, a.outFile, a.mleTree, a.probThreshold,
                        a.nonBiasProbThreshold)


if __name__ == "__main__":
    main()
