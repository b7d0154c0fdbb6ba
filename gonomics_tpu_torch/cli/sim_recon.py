"""simRecon: simulate evolution down a tree, reconstruct the ancestors
from the leaves and score the reconstruction, a copy of
``gonomics_tpu/cli/sim_recon.py`` (86 lines, whole), gonomics'
``cmd/simRecon``, its flags and defaults unchanged.

    gonomics-torch simRecon [--baseAccFile by_base.txt] [--setSeed 1]
        root.fa tree.nh genes.gp sim.fa leaves.fa recon.fa accuracy.txt

The genic model (``simulate.simulate_genic``, no deletions) draws from
``GoRand(--setSeed)``; seed 1 is the stream gonomics' goldens encode.
sim.fa holds every node, leaves.fa the leaves, recon.fa the leaves and
then the reconstructed internal nodes. accuracy.txt has a
``name<TAB>percent`` line a node, its ``exon`` and ``nonCoding`` lines,
and ``All Reconstructed Nodes``, in insertion order; --baseAccFile a
line for each node's first, second and third codon position.
"""

from __future__ import annotations

import argparse

from .. import fileio, simulate
from ..io import fasta as fastaio
from ..numbers.gorand import GoRand
from ..phylo import etree
from ..phylo.reconstruct import recon_accuracy, reconstruct_tree


def simulate_evolve(root_fasta: str, tree_file: str, gp: str,
                    sim_out: str, leaf_out: str, rng) -> None:
    """cmd/simRecon SimulateEvolve (simRecon.go:18)."""
    tree = etree.read_tree(tree_file, root_fasta)
    simulate.simulate_genic(root_fasta, tree, gp, False, rng)
    nodes = etree.get_tree(tree)
    fastaio.write(sim_out, [n.fasta for n in nodes])
    fastaio.write(leaf_out, [n.fasta for n in nodes
                             if n.left is None and n.right is None])


def reconstruct_seq(newick_input: str, fasta_input: str,
                    output_filename: str) -> None:
    """cmd/simRecon ReconstructSeq (simRecon.go:36): the leaves, then the
    internal nodes."""
    tree = etree.read_tree(newick_input, fasta_input)
    reconstruct_tree(tree)
    out = [leaf.fasta for leaf in etree.get_leaves(tree)]
    out.extend(br.fasta for br in etree.get_branch(tree))
    fastaio.write(output_filename, out)


def sim_recon(root_fasta: str, tree_file: str, gp: str, sim_out: str,
              leaf_out: str, recon_out: str, accuracy_out: str,
              base_acc_file: str = "", set_seed: int = 1) -> None:
    rng = GoRand(set_seed)
    simulate_evolve(root_fasta, tree_file, gp, sim_out, leaf_out, rng)
    reconstruct_seq(tree_file, leaf_out, recon_out)
    answer, by_base = recon_accuracy(sim_out, recon_out, leaf_out, gp,
                                     bool(base_acc_file))
    with fileio.easy_create(accuracy_out) as out:
        for name, accuracy in answer.items():
            out.write(f"{name}\t{accuracy:f}\n")
    if base_acc_file:
        with fileio.easy_create(base_acc_file) as out:
            for species, base_acc in by_base.items():
                labels = [f"{species} First Base", f"{species} Second Base",
                          f"{species} Third Base"]
                for label, acc in zip(labels, base_acc):
                    out.write(f"{label}\t{acc:f}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simRecon")
    p.add_argument("--baseAccFile", default="")
    p.add_argument("--setSeed", type=int, default=1)
    p.add_argument("rootFasta")
    p.add_argument("tree")
    p.add_argument("genePred")
    p.add_argument("simOut")
    p.add_argument("leafOut")
    p.add_argument("reconOut")
    p.add_argument("accuracyOut")
    a = p.parse_args(argv)
    sim_recon(a.rootFasta, a.tree, a.genePred, a.simOut, a.leafOut,
              a.reconOut, a.accuracyOut, a.baseAccFile, a.setSeed)


if __name__ == "__main__":
    main()
