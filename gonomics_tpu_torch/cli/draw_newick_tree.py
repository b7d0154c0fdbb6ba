"""drawNewickTree: a newick tree drawn as a PNG, a copy of
``gonomics_tpu/cli/draw_newick_tree.py`` (31 lines), gonomics'
``cmd/drawNewickTree/drawNewickTree.go``.

    gonomics-torch drawNewickTree [-imgWidth 1500] [-imgHeight 1500]
        in.nh out.png

It needs PIL (``sketch.py``); no other tool of the umbrella does.
"""

from __future__ import annotations

import argparse

from ..phylo import draw as treedraw
from ..phylo import simpletree


def draw_newick_tree(newick_file: str, png_file: str,
                     img_width: int, img_height: int) -> None:
    """cmd/drawNewickTree/drawNewickTree.go:19-41."""
    nt = simpletree.read_newick(newick_file)
    img = treedraw.draw(nt, img_width, img_height)
    img.save(png_file, "PNG")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="drawNewickTree")
    p.add_argument("-imgWidth", type=int, default=1500)
    p.add_argument("-imgHeight", type=int, default=1500)
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    draw_newick_tree(a.input, a.output, a.imgWidth, a.imgHeight)


if __name__ == "__main__":
    main()
