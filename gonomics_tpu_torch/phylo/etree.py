"""Newick trees whose nodes carry FASTA records, and their substitution
matrices, and their newick text: a copy of ``gonomics_tpu/phylo/etree.py``
(209 lines, whole), gonomics' ``expandedTree``.

Parsing follows expandedTree.parseNewick (expandedTree.go:140-196),
with its default branch length of 1 for topology-only trees, and the
traversal orders (GetTree: node, right, left; GetBranch and GetLeaves:
left before right) that fix the order of the records written out.
``read_tree`` leaves a leaf with no record of its name at
``fasta = None``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import fileio
from ..io import fasta as fastaio
from ..numbers.matrix import fractional_symmetric_matrix_exponentiation


@dataclass
class ETree:
    name: str = ""
    branch_length: float = 0.0   # Go zero value
    only_topology: bool = False
    fasta: fastaio.Fasta | None = None
    left: "ETree | None" = None
    right: "ETree | None" = None
    up: "ETree | None" = None
    substitution_matrix: np.ndarray | None = None


def _splitting_comma(s: str) -> int:
    open_c = closed_c = 0
    for i, r in enumerate(s):
        if r == "," and open_c == closed_c + 1:
            return i
        if r == "(":
            open_c += 1
        elif r == ")":
            closed_c += 1
    return -1


def _split_name_length(s: str) -> tuple[str, float, bool]:
    n = s.count(":")
    if n == 0:
        return s, 1.0, True
    if n == 1:
        i = s.rindex(":")
        return s[:i], float(s[i + 1:]), False
    raise ValueError(f"{s} should only have one or two colons")


def _parse_helper(s: str) -> ETree:
    if not s:
        raise ValueError("can not build tree/node from an empty string")
    if s.count("(") != s.count(")"):
        raise ValueError(f"{s} has unbalanced parentheses")
    if s.count("(") == 0:
        name, bl, topo = _split_name_length(s)
        return ETree(name=name, branch_length=bl, only_topology=topo)
    first_open = s.index("(")
    last_closed = s.rindex(")")
    comma = _splitting_comma(s)
    name, bl, topo = _split_name_length(s[last_closed + 1:])
    node = ETree(name=name, branch_length=bl, only_topology=topo)
    node.left = _parse_helper(s[first_open + 1:comma])
    node.right = _parse_helper(s[comma + 1:last_closed])
    return node


def parse_newick(s: str) -> ETree:
    s = s[s.index("("):s.rindex(";") + 1]
    if not s.startswith("(") or not s.endswith(";"):
        raise ValueError("tree should start with '(' and end with ';'")
    root = _parse_helper(s[:-1])
    _set_up(root, None)
    return root


def read_newick(filename: str) -> ETree:
    text = "".join(fileio.read(filename))
    return parse_newick(text)


def _set_up(node: ETree, prev: ETree | None) -> None:
    node.up = prev
    if node.left is not None and node.right is not None:
        _set_up(node.left, node)
        _set_up(node.right, node)


def read_tree(newick_file: str, fasta_file: str) -> ETree:
    """expandedTree.ReadTree: parse + attach leaf fastas by name, create
    empty fastas for internal nodes."""
    root = read_newick(newick_file)
    records = fastaio.read(fasta_file)
    by_name = {r.name: r for r in records}
    for leaf in get_leaves(root):
        if leaf.name in by_name:
            leaf.fasta = by_name[leaf.name]
    for br in get_branch(root):
        br.fasta = fastaio.Fasta(br.name, np.zeros(0, np.int8))
    return root


def get_tree(node: ETree) -> list[ETree]:
    out = [node]
    if node.right is not None:
        out.extend(get_tree(node.right))
    if node.left is not None:
        out.extend(get_tree(node.left))
    return out


def get_branch(node: ETree) -> list[ETree]:
    out: list[ETree] = []
    if node.left is not None and node.right is not None:
        out.append(node)
        out.extend(get_branch(node.left))
        out.extend(get_branch(node.right))
    return out


def get_leaves(node: ETree) -> list[ETree]:
    out: list[ETree] = []
    if node.left is not None and node.right is not None:
        out.extend(get_leaves(node.left))
        out.extend(get_leaves(node.right))
    if node.left is None and node.right is None:
        out.append(node)
    return out


def find_node(node: ETree | None, name: str) -> ETree | None:
    if node is None:
        return None
    if node.name == name:
        return node
    found = find_node(node.left, name)
    if found is not None:
        return found
    return find_node(node.right, name)


# --- substitution matrices (expandedTree/substitutionMatrix.go) ---

DEFAULT_SUBSTITUTION_MATRIX = [
    [0.91, 0.03, 0.03, 0.03],
    [0.03, 0.91, 0.03, 0.03],
    [0.03, 0.03, 0.91, 0.03],
    [0.03, 0.03, 0.03, 0.91],
]


def parse_substitution_matrix(filename: str):
    """simulate.ParseSubstitutionMatrix (nonCoding.go:71): 4x4 TSV, or
    the Jukes-Cantor-like default when no file is given."""
    if not filename:
        return [row[:] for row in DEFAULT_SUBSTITUTION_MATRIX]
    with fileio.easy_open(filename) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    if len(lines) != 4:
        raise ValueError(f"expected 4 lines in substitution matrix, "
                         f"found {len(lines)}")
    out = []
    for ln in lines:
        words = ln.split("\t")
        if len(words) != 4:
            raise ValueError("expected 4 fields per matrix line")
        out.append([float(w) for w in words])
    return out


def populate_substitution_matrices(node: ETree, unit_matrix,
                                   unit_branch_length: float) -> None:
    """expandedTree.PopulateSubstitutionMatrices
    (substitutionMatrix.go:13): per-branch S^(t/unit)."""
    unit = np.asarray(unit_matrix, np.float64)
    node.substitution_matrix = fractional_symmetric_matrix_exponentiation(
        unit, node.branch_length / unit_branch_length)
    if node.left is not None:
        populate_substitution_matrices(node.left, unit_matrix,
                                       unit_branch_length)
    if node.right is not None:
        populate_substitution_matrices(node.right, unit_matrix,
                                       unit_branch_length)


def to_newick_string(node: ETree) -> str:
    """expandedTree.ToNewickString (expandedTree.go:261): the tree as a
    ``simpletree.Tree``, written by ``simpletree.to_string`` (``%f``
    lengths, left child first)."""
    from . import simpletree

    def convert(n: ETree | None):
        if n is None:
            return None
        t = simpletree.Tree(name=n.name, only_topology=n.only_topology,
                            branch_length=n.branch_length)
        t.left = convert(n.left)
        t.right = convert(n.right)
        return t

    return simpletree.to_string(convert(node))
