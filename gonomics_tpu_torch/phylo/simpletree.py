"""Plain binary trees, dot and newick: a copy of
``gonomics_tpu/phylo/simpletree.py`` (140 lines, whole), gonomics'
``tree/tree.go``.

Unlike ``etree.ETree``, a newick node without ``:length`` reads as
length 1.0 and is marked as topology only, and ``to_string`` writes
lengths with ``%f`` (six decimals) and leaves them off topology-only
nodes (tree.go:216-251). ``parse_dot`` (tree.go:44-121) builds the tree
from ``parent -> child`` digraph lines: it splits a line at `` -> ``,
cuts each word at its first ``;`` and keeps any leading whitespace, so
an indented line names new nodes; the first node seen is the root; a
first child goes left, a second right, and a third raises. An empty
dot file fails its ``assert``. ``read_newick`` joins the lines with no
separator; an empty file raises ``ValueError`` from ``str.index``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import fileio


@dataclass
class Tree:
    name: str = ""
    only_topology: bool = False  # Go zero values
    branch_length: float = 0.0
    left: "Tree | None" = None
    right: "Tree | None" = None


def parse_dot(filename: str) -> Tree:
    """tree.ParseDot: digraph lines "A -> B -> C;" chain children under
    parents; a node's first child goes left, second right."""
    root: Tree | None = None
    nodes: dict[str, Tree] = {}
    for line in fileio.read(filename):
        words = [w.split(";")[0] for w in line.split(" -> ")]
        if len(words) < 2:
            if words[0] == "}" or words[0].split(" ")[0] == "digraph":
                continue
            raise ValueError(f"Invalid line: {words[0]}.")
        prev: Tree | None = None
        for word in words:
            if word not in nodes:
                current = Tree(name=word, only_topology=True,
                               branch_length=0.0)  # tree.go:88
                if not nodes:
                    root = current
                nodes[word] = current
            else:
                current = nodes[word]
            if prev is not None:
                if prev.left is not None:
                    if prev.right is not None:
                        raise ValueError("Trees must be binary.")
                    prev.right = current
                else:
                    prev.left = current
            prev = current
    assert root is not None
    return root


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


def _parse_helper(s: str) -> Tree:
    if not s:
        raise ValueError("can not build tree/node from an empty string")
    if s.count("(") == 0:
        name, bl, topo = _split_name_length(s)
        return Tree(name=name, branch_length=bl, only_topology=topo)
    first_open = s.index("(")
    last_closed = s.rindex(")")
    comma = _splitting_comma(s)
    name, bl, topo = _split_name_length(s[last_closed + 1:])
    node = Tree(name=name, branch_length=bl, only_topology=topo)
    node.left = _parse_helper(s[first_open + 1:comma])
    node.right = _parse_helper(s[comma + 1:last_closed])
    return node


def parse_newick(s: str) -> Tree:
    if not s.startswith("(") or not s.endswith(";"):
        raise ValueError("tree should start with '(' and end with ';'")
    return _parse_helper(s[:-1])


def read_newick(filename: str) -> Tree:
    text = "".join(fileio.read(filename))
    if text.startswith("#"):
        raise ValueError("tree file is either empty or has no non-comment lines")
    return parse_newick(text[text.index("("):text.rindex(";") + 1])


def _to_string_helper(parts: list[str], node: Tree) -> None:
    if node.left is None and node.right is None:
        if node.only_topology:
            parts.append(node.name)
        else:
            parts.append(f"{node.name}:{node.branch_length:f}")
    else:
        parts.append("(")
        if node.left is not None:
            _to_string_helper(parts, node.left)
        parts.append(",")
        if node.right is not None:
            _to_string_helper(parts, node.right)
        if node.only_topology:
            parts.append(f"){node.name}")
        else:
            parts.append(f"){node.name}:{node.branch_length:f}")


def to_string(node: Tree | None) -> str:
    if node is None:
        return ""
    parts: list[str] = []
    _to_string_helper(parts, node)
    return "".join(parts) + ";"


def write_newick(filename: str, node: Tree) -> None:
    with fileio.easy_create(filename) as f:
        f.write(to_string(node) + "\n")
