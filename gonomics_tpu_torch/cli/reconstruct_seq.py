"""reconstructSeq: ancestral sequences for every internal node of a
newick tree over a multiFa alignment, a copy of
``gonomics_tpu/cli/reconstruct_seq.py`` (114 lines, whole), its flags and
defaults unchanged.

    gonomics-torch reconstructSeq tree.nh aln.fa out.fa [-biasLeafName n]
        [-biasNodeName n] [-nonBiasProbThreshold 0] [-biasN]
        [-highestProbThreshold 0] [-keepAllSeq] [-subMatrix]
        [-substitutionMatrixFile f] [-unitBranchLength -1]
        [-pDnaNode n -pDnaOutFile out.pfa]

The output holds the leaves, then the internal nodes in the tree's
order. ``-keepAllSeq`` adds the alignment's records that are not in the
tree: the first record in front of all, the others after. ``-pDnaNode``
writes that node's probabilities at the columns where it has a base.
The JAX function's ``pdna_node_multi`` keyword, which has no flag there,
is left out.
"""

from __future__ import annotations

import argparse

from ..io import fasta as fastaio
from ..io import pfasta
from ..phylo.etree import (get_branch, get_leaves,
                           parse_substitution_matrix,
                           populate_substitution_matrices, read_tree)
from ..phylo.reconstruct import reconstruct_tree


def reconstruct_seq(newick_file: str, fasta_file: str, out_file: str, *,
                    bias_leaf_name: str = "", bias_node_name: str = "",
                    non_bias_prob_threshold: float = 0.0,
                    bias_n: bool = False,
                    highest_prob_threshold: float = 0.0,
                    keep_all_seq: bool = False, sub_matrix: bool = False,
                    substitution_matrix_file: str = "",
                    unit_branch_length: float = -1.0,
                    pdna_node: str = "", pdna_out_file: str = "") -> None:
    if not 0 <= non_bias_prob_threshold <= 1:
        raise SystemExit("Error: nonBiasProbThreshold must be a value "
                         "between 0 and 1.")
    if non_bias_prob_threshold > 0 and not bias_leaf_name:
        raise SystemExit("Error: nonBiasProbThreshold was set, but no "
                         "BiasLeafName was provided.")
    if not 0 <= highest_prob_threshold <= 1:
        raise SystemExit("Error: highestProbThreshold must be a value "
                         "between 0 and 1.")

    root = read_tree(newick_file, fasta_file)
    if sub_matrix:
        unit = parse_substitution_matrix(substitution_matrix_file)
        populate_substitution_matrices(root, unit, unit_branch_length)
    pdna_rec = reconstruct_tree(
        root, bias_leaf_name=bias_leaf_name, bias_node_name=bias_node_name,
        non_bias_threshold=non_bias_prob_threshold, bias_n=bias_n,
        highest_threshold=highest_prob_threshold, sub_matrix=sub_matrix,
        pdna_node=pdna_node)

    records = [leaf.fasta for leaf in get_leaves(root)]
    records += [br.fasta for br in get_branch(root)]

    if keep_all_seq:
        extra = fastaio.read(fasta_file)
        have = {r.name for r in records}
        for i, rec in enumerate(extra):
            if rec.name not in have:
                if i == 0:
                    records = [rec] + records
                else:
                    records.append(rec)

    fastaio.write(out_file, records)

    if pdna_node:
        pfasta.write(pdna_out_file, [pdna_rec])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="reconstructSeq")
    p.add_argument("newick")
    p.add_argument("fasta")
    p.add_argument("out")
    p.add_argument("-biasLeafName", default="")
    p.add_argument("-biasNodeName", default="")
    p.add_argument("-nonBiasProbThreshold", type=float, default=0.0)
    p.add_argument("-biasN", action="store_true")
    p.add_argument("-highestProbThreshold", type=float, default=0.0)
    p.add_argument("-keepAllSeq", action="store_true")
    p.add_argument("-subMatrix", action="store_true")
    p.add_argument("-substitutionMatrixFile", default="")
    p.add_argument("-unitBranchLength", type=float, default=-1.0)
    p.add_argument("-pDnaNode", default="")
    p.add_argument("-pDnaOutFile", default="")
    a = p.parse_args(argv)
    reconstruct_seq(a.newick, a.fasta, a.out,
                    bias_leaf_name=a.biasLeafName,
                    bias_node_name=a.biasNodeName,
                    non_bias_prob_threshold=a.nonBiasProbThreshold,
                    bias_n=a.biasN,
                    highest_prob_threshold=a.highestProbThreshold,
                    keep_all_seq=a.keepAllSeq, sub_matrix=a.subMatrix,
                    substitution_matrix_file=a.substitutionMatrixFile,
                    unit_branch_length=a.unitBranchLength,
                    pdna_node=a.pDnaNode,
                    pdna_out_file=a.pDnaOutFile)


if __name__ == "__main__":
    main()
