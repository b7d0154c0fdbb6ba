"""oboToDot: the dot-format subtree under a GO term; a copy of
``gonomics_tpu/cli/obo_to_dot.py`` (27 lines, whole), gonomics'
``cmdx/oboToDot/oboToDot.go``.

    gonomics-torch oboToDot in.obo GO:0000001 out.dot

The term may be an alt id; an unknown term exits."""

from __future__ import annotations

import argparse
import sys

from ..ontology import obo


def obo_to_dot(obo_file: str, term: str, output: str) -> None:
    records, _ = obo.read(obo_file, False)
    obo.subtree_to_dot(output, term, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="oboToDot")
    p.add_argument("obo")
    p.add_argument("goId")
    p.add_argument("out")
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    obo_to_dot(a.obo, a.goId, a.out)


if __name__ == "__main__":
    main()
