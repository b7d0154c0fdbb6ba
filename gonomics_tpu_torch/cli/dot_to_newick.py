"""dotToNewick: a newick tree from a dot-format digraph, a copy of
``gonomics_tpu/cli/dot_to_newick.py`` (25 lines), gonomics'
``cmd/dotToNewick/dotToNewick.go``.

    gonomics-torch dotToNewick in.dot out.nh

The newick names the nodes only: the dot file gives no lengths.
"""

from __future__ import annotations

import argparse

from ..phylo import simpletree


def dot_to_newick(in_file: str, out_file: str) -> None:
    simpletree.write_newick(out_file, simpletree.parse_dot(in_file))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dotToNewick")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    dot_to_newick(a.input, a.output)


if __name__ == "__main__":
    main()
