"""simulateEvol: sequence evolution along a tree, a copy of
``gonomics_tpu/cli/simulate_evol.py`` (169 lines, whole), gonomics'
``cmd/simulateEvol``, its subcommands, flags and defaults unchanged.

    gonomics-torch simulateEvol genic [--setSeed -1]
        [--completeSimOutput all.fa] [--genePred genes.gp]
        tree.nh root.fa leaves.fa
    gonomics-torch simulateEvol withIndels [--lambdaValue|-lambda 1]
        [--propIndel 0] [--branchLength 0] [--gcContent 0.42]
        [--setSeed -1] [--qName evol] [--vcfOutFile out.vcf]
        [--transitionBias 1] in.fa out.fa
    gonomics-torch simulateEvol nonCoding [--treeFile tree.nh]
        [--fastaFile root.fa] [--numNodes 13] [--gammaAlpha 1]
        [--gammaBeta 50] [--gcContent 0.41] [--lenSeq 100]
        [--unitBranchLength -100]
        [--substitutionMatrix|--substitutionMatrixFile m.txt]
        [--newickOut tree.nh] [--setSeed -1] out.fa

Each subcommand draws from a ``GoRand`` of its own, gonomics' stream.
``genic`` writes the leaves (every node with ``--completeSimOutput``);
it needs ``--genePred``, and a genePred without its 11th (frames)
column raises IndexError, as in the JAX. ``withIndels`` writes the
input and its mutated copy as a pairwise alignment. ``nonCoding``
renames the root node of a ``--fastaFile`` tree to ``root`` and keeps
the record's own name in the output.
"""

from __future__ import annotations

import argparse

from .. import dna, fileio, simulate
from ..io import fasta as fastaio
from ..numbers.gorand import GoRand
from ..numbers.gosamplers import rand_gamma
from ..phylo import etree as etreemod
from ..phylo.etree import get_tree, read_newick, to_newick_string
from .rand_seq import rand_intergenic_seq


def genic(tree_file: str, in_file: str, out_file: str, *, set_seed: int = 1,
          sim_out_file: str = "", gene_pred_file: str = "") -> None:
    rng = GoRand(set_seed)
    tree = etreemod.read_tree(tree_file, in_file)
    simulate.simulate_genic(in_file, tree, gene_pred_file, True, rng)
    nodes = get_tree(tree)
    if sim_out_file:
        fastaio.write(sim_out_file, [n.fasta for n in nodes])
    fastaio.write(out_file, [n.fasta for n in nodes
                             if n.left is None and n.right is None])


def with_indels(in_file: str, out_file: str, *, lambda_: float = 1.0,
                prop_indels: float = 0.0, branch_length: float = 0.0,
                gc_content: float = 0.42, set_seed: int = -1,
                q_name: str = "evol", vcf_out_file: str = "",
                transition_bias: float = 1.0) -> None:
    if not 0 <= prop_indels <= 1:
        raise SystemExit("The propIndels option must be a value between 0 "
                         "and 1.")
    if not 0 <= gc_content <= 1:
        raise SystemExit("GcContent must be a value between 0 and 1.")
    if transition_bias < 0:
        raise SystemExit("TransitionBias must be a nonnegative number.")
    if not 0 <= branch_length <= 1:
        raise SystemExit("The branchLength argument must be a value between "
                         "0 and 1.")
    rng = GoRand(set_seed)
    out = simulate.with_indels(rng, in_file, branch_length, prop_indels,
                               lambda_, gc_content, transition_bias,
                               vcf_out_file, q_name)
    fastaio.write(out_file, out)


def non_coding(out_file: str, *, tree_file: str = "", fasta_file: str = "",
               num_nodes: int = 13, gamma_alpha: float = 1.0,
               gamma_beta: float = 50.0, gc_content: float = 0.41,
               len_seq: int = 100, unit_branch_length: float = -100.0,
               substitution_matrix_file: str = "", newick_out: str = "",
               set_seed: int = -1) -> None:
    """cmd/simulateEvol nonCoding (nonCoding.go:97)."""
    rng = GoRand(set_seed)
    if gamma_alpha <= 0 or gamma_beta <= 0:
        raise SystemExit("Error: expected Gamma distribution parameters to "
                         "be positive numbers.")
    if not 0 <= gc_content <= 1:
        raise SystemExit(f"Error: GcContent must be a value between 0 and "
                         f"1. Found: {gc_content}.")
    if len_seq < 0:
        raise SystemExit(f"Error: expected lenSeq to be a positive number. "
                         f"Found: {len_seq}.")
    if tree_file:
        root = read_newick(tree_file)
    else:
        root = simulate.sim_etree(rng, num_nodes, gamma_alpha, gamma_beta)
    if unit_branch_length < 0:
        unit_branch_length = rand_gamma(rng, gamma_alpha, gamma_beta)[0]
    if fasta_file:
        records = fastaio.read(fasta_file)
        if len(records) != 1:
            raise SystemExit(f"Error: expected 1 sequence in the input "
                             f"fasta file. Received: {len(records)}.")
        # the reference renames the node to "root" but keeps the fasta
        # record's own name in the output (nonCoding.go:124-126)
        records[0].seq = dna.to_upper(records[0].seq)
        root.fasta = records[0]
        root.name = "root"
    else:
        root.fasta = fastaio.Fasta(
            "root", rand_intergenic_seq(rng, gc_content, len_seq))
    root = simulate.non_coding(root, substitution_matrix_file,
                               unit_branch_length, rng)
    fastaio.write(out_file, [n.fasta for n in get_tree(root)])
    if newick_out:
        with fileio.easy_create(newick_out) as f:
            f.write(to_newick_string(root) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="simulateEvol")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("genic")
    g.add_argument("--setSeed", type=int, default=-1)
    g.add_argument("--completeSimOutput", default="")
    g.add_argument("--genePred", default="")
    g.add_argument("tree")
    g.add_argument("input")
    g.add_argument("output")

    w = sub.add_parser("withIndels")
    w.add_argument("--lambdaValue", "-lambda", type=float, default=1.0)
    w.add_argument("--propIndel", type=float, default=0.0)
    w.add_argument("--branchLength", type=float, default=0.0)
    w.add_argument("--gcContent", type=float, default=0.42)
    w.add_argument("--setSeed", type=int, default=-1)
    w.add_argument("--qName", default="evol")
    w.add_argument("--vcfOutFile", default="")
    w.add_argument("--transitionBias", type=float, default=1.0)
    w.add_argument("input")
    w.add_argument("output")

    n = sub.add_parser("nonCoding")
    n.add_argument("--treeFile", default="")
    n.add_argument("--fastaFile", default="")
    n.add_argument("--numNodes", type=int, default=13)
    n.add_argument("--gammaAlpha", type=float, default=1.0)
    n.add_argument("--gammaBeta", type=float, default=50.0)
    n.add_argument("--gcContent", type=float, default=0.41)
    n.add_argument("--lenSeq", type=int, default=100)
    n.add_argument("--unitBranchLength", type=float, default=-100.0)
    n.add_argument("--substitutionMatrix", "--substitutionMatrixFile",
                   default="")
    n.add_argument("--newickOut", default="")
    n.add_argument("--setSeed", type=int, default=-1)
    n.add_argument("output")

    a = p.parse_args(argv)
    if a.cmd == "genic":
        genic(a.tree, a.input, a.output, set_seed=a.setSeed,
              sim_out_file=a.completeSimOutput, gene_pred_file=a.genePred)
    elif a.cmd == "withIndels":
        with_indels(a.input, a.output, lambda_=a.lambdaValue,
                    prop_indels=a.propIndel, branch_length=a.branchLength,
                    gc_content=a.gcContent, set_seed=a.setSeed,
                    q_name=a.qName, vcf_out_file=a.vcfOutFile,
                    transition_bias=a.transitionBias)
    else:
        non_coding(a.output, tree_file=a.treeFile, fasta_file=a.fastaFile,
                   num_nodes=a.numNodes, gamma_alpha=a.gammaAlpha,
                   gamma_beta=a.gammaBeta, gc_content=a.gcContent,
                   len_seq=a.lenSeq, unit_branch_length=a.unitBranchLength,
                   substitution_matrix_file=a.substitutionMatrix,
                   newick_out=a.newickOut, set_seed=a.setSeed)


if __name__ == "__main__":
    main()
