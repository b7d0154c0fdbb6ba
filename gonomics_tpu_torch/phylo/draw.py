"""Trees drawn as images: a copy of ``gonomics_tpu/phylo/draw.py``
(52 lines, whole), gonomics' ``tree/draw.go``.

drawHelper's layout: x is the cumulative branch length at 1000 px a
unit, so a root with no length is drawn 1000 px wide; each node takes a
row 10 px tall; an inner node joins its children with vertical lines.
It needs PIL, through ``sketch``; ``phylo/__init__.py`` does not import
this module.
"""

from __future__ import annotations

from PIL import Image

from .. import sketch
from .simpletree import Tree


def _draw_helper(img: Image.Image, node: Tree, height_above: float,
                 px_per_branch: float, px_per_node: int,
                 state: list[int]) -> int:
    """tree/draw.go:27-52 drawHelper; state[0] = nodesPrinted."""
    x_start = int(height_above * px_per_branch)
    x_end = int((height_above + node.branch_length) * px_per_branch)
    x = x_end

    if node.left is not None:
        y_start = _draw_helper(img, node.left,
                               height_above + node.branch_length,
                               px_per_branch, px_per_node, state)
        y_end = state[0] * px_per_node + px_per_node // 2
        sketch.v_line(img, x, y_start, y_end, sketch.BLACK)

    y = state[0] * px_per_node + px_per_node // 2
    sketch.h_line(img, x_start, x_end, y, sketch.BLACK)
    state[0] += 1
    sketch.text(img, node.name, x + 5, state[0] * px_per_node)

    if node.right is not None:
        y_start = y
        y_end = _draw_helper(img, node.right,
                             height_above + node.branch_length,
                             px_per_branch, px_per_node, state)
        sketch.v_line(img, x_end, y_start, y_end, sketch.BLACK)
    return y


def draw(node: Tree | None, image_width: int,
         image_height: int) -> Image.Image:
    """tree.Draw (draw.go:56-69): white canvas, 1000 px per unit branch
    length, 10 px per node row."""
    img = sketch.new_image(image_width, image_height)
    if node is None:
        raise ValueError("unable to draw an empty tree")
    _draw_helper(img, node, 0.0, 1000.0, 10, [0])
    return img
