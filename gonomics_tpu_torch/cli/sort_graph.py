"""sortGraph: topologically sort genome-graph nodes; a copy of
``gonomics_tpu/cli/sort_graph.py`` (27 lines, whole), gonomics'
``cmd/sortGraph``."""

from __future__ import annotations

import argparse

from .. import graph as gg


def sort_graph(in_file: str, out_file: str) -> None:
    """cmd/sortGraph/sortGraph.go:22-26."""
    g = gg.read(in_file)
    g = gg.sort_graph(g)
    gg.write(out_file, g)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sortGraph")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    sort_graph(a.input, a.output)


if __name__ == "__main__":
    main()
