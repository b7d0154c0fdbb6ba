"""The port's plain trees, dotToNewick, sketch, tree drawing and
drawNewickTree (gonomics_tpu_torch/phylo/simpletree.py,
cli/dot_to_newick.py, sketch.py, phylo/draw.py, cli/draw_newick_tree.py)
on the CPU against the JAX package: every public name, the trees as
nested tuples, the newick text, the images as pixel arrays and the
tools' files (the PNG as its bytes) and exits, on dot files and newick
trees built here, some from a numpy seed; and one case for each of the
reference's quirks.
"""

import numpy as np
import pytest
from PIL import Image

from gonomics_tpu import sketch as jsketch
from gonomics_tpu.cli import dot_to_newick as jdot
from gonomics_tpu.cli import draw_newick_tree as jdraw_cli
from gonomics_tpu.phylo import draw as jdraw
from gonomics_tpu.phylo import simpletree as jst
from gonomics_tpu_torch import sketch as tsketch
from gonomics_tpu_torch.cli import dot_to_newick as tdot
from gonomics_tpu_torch.cli import draw_newick_tree as tdraw_cli
from gonomics_tpu_torch.phylo import draw as tdraw
from gonomics_tpu_torch.phylo import simpletree as tst

PRIMATES = ("(((((hg38:0.006,panTro6:0.007)hp:0.002,gorGor5:0.009)hpg:0.01,"
            "ponAbe3:0.018)hpgp:0.02,rheMac10:0.03)hpgpr:0.1,"
            "calJac4:0.07)root;")


def _tup(node):
    if node is None:
        return None
    return (node.name, node.only_topology, node.branch_length,
            _tup(node.left), _tup(node.right))


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:
        return "raise", type(e).__name__, str(e)


def _write(path, lines):
    path.write_text("".join(ln + "\n" for ln in lines))
    return str(path)


def _rand_newick(rng, n_leaves, lengths=True):
    """A random binary tree in newick; lengths on a random share of the
    nodes, the root without one."""
    nodes = [f"L{i}" for i in range(n_leaves)]
    k = 0
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b, a = nodes.pop(j), nodes.pop(i)

        def lab(s):
            if lengths and rng.random() < 0.7:
                return f"{s}:{rng.random() * 0.3:.4f}"
            return s

        nodes.append(f"({lab(a)},{lab(b)})I{k}")
        k += 1
    return nodes[0] + ";"


def _rand_dot(rng, n_leaves):
    """Edges of a random binary tree as digraph lines, parents before
    their children, half of the left edges chained one deeper
    (``p -> a -> a's left;``)."""
    children = {}
    nodes = [f"n{i}" for i in range(n_leaves)]
    k = 0
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b, a = nodes.pop(j), nodes.pop(i)
        children[f"p{k}"] = [a, b]
        nodes.append(f"p{k}")
        k += 1
    root = nodes[0]
    lines, left_done, stack = [], set(), [root]
    while stack:
        p = stack.pop()
        if p not in children:
            continue
        a, b = children[p]
        if p not in left_done:
            if a in children and rng.random() < 0.5:
                lines.append(f"{p} -> {a} -> {children[a][0]};")
                left_done.add(a)
            else:
                lines.append(f"{p} -> {a};")
        lines.append(f"{p} -> {b};")
        stack.extend([b, a])
    return ["digraph G {"] + lines + ["}"], root, children


# --- simpletree ---

@pytest.mark.parametrize("seed", range(6))
def test_newick_parse_and_text_equal_jax(seed, tmp_path):
    rng = np.random.default_rng(3210 + seed)
    text = _rand_newick(rng, 3 + seed * 2, lengths=seed % 3 != 0)
    jt, tt = jst.parse_newick(text), tst.parse_newick(text)
    assert _tup(tt) == _tup(jt)
    assert tst.to_string(tt) == jst.to_string(jt)
    f = _write(tmp_path / "t.nh", ["# a comment", text[:7], text[7:]])
    assert _tup(tst.read_newick(f)) == _tup(jst.read_newick(f))
    for mod, t in (("j", jt), ("t", tt)):
        (jst if mod == "j" else tst).write_newick(str(tmp_path / mod), t)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("text", [
    "(a,b);", "(a:1,b:2.5)r:0.5;", PRIMATES, "((a,b),c);", "a;",
    "(a,b)", "((a:1:2,b),c);", "((a,,b);", "(,a);", "(a:x,b);", ""])
def test_newick_outcomes_equal_jax(text):
    """Values and errors, type and message, for good and bad newick."""
    j = _outcome(lambda: _tup(jst.parse_newick(text)))
    t = _outcome(lambda: _tup(tst.parse_newick(text)))
    assert t == j
    for s in (text, text.rstrip(";"), "a:b:c", "x:1.5", "(", "()"):
        assert tst._splitting_comma(s) == jst._splitting_comma(s)
        assert _outcome(tst._split_name_length, s) == _outcome(
            jst._split_name_length, s)
        assert (_outcome(lambda: _tup(tst._parse_helper(s)))
                == _outcome(lambda: _tup(jst._parse_helper(s))))


def test_topology_only_nodes():
    """A node without :length reads as 1.0, marked topology only, and
    is written without a length; the root usually has none; lengths are
    written with six decimals."""
    t = tst.parse_newick("((a,b:0.25)x,c:2)r;")
    assert (t.name, t.branch_length, t.only_topology) == ("r", 1.0, True)
    assert (t.left.name, t.left.branch_length, t.left.only_topology) == (
        "x", 1.0, True)
    assert t.left.right.only_topology is False
    assert tst.to_string(t) == "((a,b:0.250000)x,c:2.000000)r;"
    assert tst.to_string(None) == ""
    assert vars(tst.Tree()) == vars(jst.Tree()) == {
        "name": "", "only_topology": False, "branch_length": 0.0,
        "left": None, "right": None}


def test_read_newick_quirks(tmp_path):
    """Lines join with no separator; comment lines are dropped before
    the '#' test, so it cannot fire; an empty file raises ValueError
    from str.index."""
    f = _write(tmp_path / "a.nh", ["#x", "(a:1,", "b:2)r;"])
    assert tst.to_string(tst.read_newick(f)) == "(a:1.000000,b:2.000000)r;"
    for lines in ([], ["# only a comment"]):
        g = _write(tmp_path / "e.nh", lines)
        j, t = _outcome(jst.read_newick, g), _outcome(tst.read_newick, g)
        assert t == j == ("raise", "ValueError", "substring not found")


@pytest.mark.parametrize("seed", range(5))
def test_parse_dot_equals_jax(seed, tmp_path):
    rng = np.random.default_rng(3220 + seed)
    lines, root, children = _rand_dot(rng, 4 + 2 * seed)
    f = _write(tmp_path / "t.dot", lines)
    jt, tt = jst.parse_dot(f), tst.parse_dot(f)
    assert _tup(tt) == _tup(jt)
    assert tt.name == root

    def expect(n):
        kids = children.get(n)
        if not kids:
            return n
        return f"({expect(kids[0])},{expect(kids[1])}){n}"

    assert tst.to_string(tt) == expect(root) + ";"


@pytest.mark.parametrize("lines", [
    ["digraph {", "A -> B;", "A -> C;", "  B -> F;", "}"],
    ["A -> B -> C;", "A -> D;", "A -> E;"],
    ["digraph G {", "bad line", "}"],
    [],
    ["}"],
    ["R -> A;", "X -> Y;"],
    ["A -> B; extra", "A -> C;c"]])
def test_parse_dot_outcomes_equal_jax(lines, tmp_path):
    """Indented lines, a third child, bad lines, an empty file: values
    and errors as in the JAX."""
    f = _write(tmp_path / "t.dot", lines)
    j = _outcome(lambda: _tup(jst.parse_dot(f)))
    t = _outcome(lambda: _tup(tst.parse_dot(f)))
    if j[0] == "raise" and j[1] == "AssertionError":
        assert t[:2] == j[:2]
    else:
        assert t == j


def test_parse_dot_quirks(tmp_path):
    """An indented line keeps its whitespace, so '  B' is a new node cut
    off from the tree; the first node seen is the root; a third child
    raises; an empty file fails its assert."""
    f = _write(tmp_path / "a.dot",
               ["digraph {", "A -> B;", "A -> C;", "  B -> F;", "}"])
    assert tst.to_string(tst.parse_dot(f)) == "(B,C)A;"
    f = _write(tmp_path / "b.dot", ["A -> B;", "A -> C;", "A -> D;"])
    with pytest.raises(ValueError, match="Trees must be binary."):
        tst.parse_dot(f)
    f = _write(tmp_path / "c.dot", ["digraph {", "}"])
    with pytest.raises(AssertionError):
        tst.parse_dot(f)
    f = _write(tmp_path / "d.dot", ["Q -> R -> S;"])
    assert tst.to_string(tst.parse_dot(f)) == "((S,)R,)Q;"


@pytest.mark.parametrize("case", ["plain", "verbose", "missing"])
def test_dot_to_newick_tool_equals_jax(case, tmp_path):
    rng = np.random.default_rng(3230)
    lines, _, _ = _rand_dot(rng, 9)
    f = _write(tmp_path / "t.dot", lines)
    if case == "missing":
        f = str(tmp_path / "none.dot")
    res = []
    for side, main in (("jax", jdot.main), ("port", tdot.main)):
        o = tmp_path / f"{side}.nh"
        argv = (["--verbose"] if case == "verbose" else []) + [f, str(o)]
        r = _outcome(main, argv)
        res.append((r[0], o.read_bytes() if r[0] == "ok" else r[1:]))
    assert res[1] == res[0]


# --- sketch and draw ---

def _pixels(img):
    return np.asarray(img)


def test_sketch_names_equal_jax():
    assert tsketch.KELLY_PALETTE == jsketch.KELLY_PALETTE
    assert tsketch.TRUBETSKOY_PALETTE == jsketch.TRUBETSKOY_PALETTE
    assert len(tsketch.KELLY_PALETTE) == len(tsketch.TRUBETSKOY_PALETTE) == 22
    assert (tsketch.BLACK, tsketch.WHITE) == (jsketch.BLACK, jsketch.WHITE)


@pytest.mark.parametrize("seed", range(4))
def test_sketch_primitives_equal_jax(seed):
    """Each primitive, in and past the image's edges, empty ranges too,
    and text; the pixels equal the JAX's."""
    rng = np.random.default_rng(3240 + seed)
    fill = tuple(int(x) for x in rng.integers(0, 256, 3))
    imgs = [m.new_image(90, 60, fill=fill) for m in (jsketch, tsketch)]
    ops = []
    for _ in range(30):
        kind = rng.choice(["h", "v", "r", "f", "t"])
        c = tsketch.KELLY_PALETTE[int(rng.integers(0, 22))]
        a, b, y, z = (int(v) for v in rng.integers(-10, 100, 4))
        ops.append((kind, a, b, y, z, c, f"w{int(rng.integers(0, 99))}"))
    for mod, img in zip((jsketch, tsketch), imgs):
        for kind, a, b, y, z, c, word in ops:
            if kind == "h":
                mod.h_line(img, a, b, y, c)
            elif kind == "v":
                mod.v_line(img, a, y, z, c)
            elif kind == "r":
                mod.rectangle(img, a, y, b, z, c)
            elif kind == "f":
                mod.filled_rectangle(img, a, y, b, z, c)
            else:
                mod.text(img, word, a, y)
    assert np.array_equal(_pixels(imgs[1]), _pixels(imgs[0]))
    assert imgs[1].mode == "RGBA"


def test_sketch_half_open_ranges():
    img = tsketch.new_image(20, 10)
    tsketch.h_line(img, 3, 7, 2, tsketch.BLACK)
    tsketch.v_line(img, 10, 4, 6, tsketch.BLACK)
    tsketch.h_line(img, 5, 5, 8, tsketch.BLACK)
    p = _pixels(img)[..., :3]
    black = {(int(y), int(x)) for y, x in zip(*np.nonzero(p.sum(-1) == 0))}
    assert black == {(2, x) for x in range(3, 7)} | {(4, 10), (5, 10)}


@pytest.mark.parametrize("text", [PRIMATES, "((a,b),c);", "(a:0.5,b:0.2);",
                                  "((a:0.1,b:0.2)x:0.3,(c,d:0.05)y)r;"])
def test_draw_equals_jax(text):
    imgs = [m.draw(s.parse_newick(text), 1800, 200)
            for m, s in ((jdraw, jst), (tdraw, tst))]
    assert np.array_equal(_pixels(imgs[1]), _pixels(imgs[0]))
    small = [m.draw(s.parse_newick(text), 50, 30)
             for m, s in ((jdraw, jst), (tdraw, tst))]
    assert np.array_equal(_pixels(small[1]), _pixels(small[0]))
    assert small[1].size == (50, 30)
    with pytest.raises(ValueError, match="unable to draw an empty tree"):
        tdraw.draw(None, 10, 10)


def _rows(node, above, rows):
    """(x_start, x_end) of each node's horizontal line, in the row
    order of the draw (left subtree, node, right subtree)."""
    if node.left is not None:
        _rows(node.left, above + node.branch_length, rows)
    rows.append((int(above * 1000), int((above + node.branch_length)
                                        * 1000)))
    if node.right is not None:
        _rows(node.right, above + node.branch_length, rows)
    return rows


def test_draw_layout():
    """1000 px a unit of length, 10 px a row; a root with no length is
    drawn 1000 px wide; each node's line is black at row k * 10 + 5
    from x_start to x_end - 1."""
    t = tst.parse_newick("((a:0.1,b:0.2)x:0.3,(c,d:0.05)y)r;")
    img = tdraw.draw(t, 3000, 100)
    p = _pixels(img)[..., :3].sum(-1) == 0
    rows = _rows(t, 0.0, [])
    assert rows[3] == (0, 1000)  # the root, topology only
    for k, (a, b) in enumerate(rows):
        assert p[k * 10 + 5, a:b].all()


@pytest.mark.parametrize("case", ["plain", "size", "missing", "empty"])
def test_draw_newick_tree_tool_equals_jax(case, tmp_path):
    f = _write(tmp_path / "t.nh", [PRIMATES])
    argv = {"plain": [f], "size": ["-imgWidth", "700", "-imgHeight", "90",
                                   f],
            "missing": [str(tmp_path / "none.nh")],
            "empty": [_write(tmp_path / "e.nh", [])]}[case]
    res = []
    for side, main in (("jax", jdraw_cli.main), ("port", tdraw_cli.main)):
        o = tmp_path / f"{side}.png"
        r = _outcome(main, [*argv, str(o)])
        res.append((r[0], o.read_bytes() if r[0] == "ok" else r[1:]))
    assert res[1] == res[0]
    if case in ("plain", "size"):
        with Image.open(tmp_path / "port.png") as img:
            assert img.size == ((1500, 1500) if case == "plain"
                                else (700, 90))


def test_tree_text_tools_load_no_pil():
    """phylo, simpletree and dotToNewick load neither PIL nor sketch."""
    import subprocess
    import sys
    code = ("import sys, gonomics_tpu_torch.phylo,"
            " gonomics_tpu_torch.phylo.simpletree,"
            " gonomics_tpu_torch.cli.dot_to_newick\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == 'PIL'"
            " or m in ('gonomics_tpu_torch.sketch',"
            " 'gonomics_tpu_torch.phylo.draw')]\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
