"""The port's bed tools of slice 11.5 (``bedFilter``, ``bedMath``,
``bedSplit``, ``bedShear``, ``bedTrim``, ``bedDistanceFromChrEnds``,
``bedMinimumDistanceName``, ``bedSimilarity``, ``bedOverlapByWindow``,
``bedValueWig``, ``bedGraphToWig``; gonomics_tpu_torch/cli/) on the CPU
against the JAX tools: the bytes of every file they write (gzip output
decompressed, since its header holds a time) and the message of every
exit, on inputs that a numpy seed builds here: records of 3, 4, 6 and 8
fields on chr1, chr2 and chr10 (whose string order differs from their
number order), numeric and non-numeric names, names with "/", empty and
duplicate records, fixed-step wigs and bedGraphs. Each quirk of the
reference that the port keeps is pinned by a case here. Also the library
under them: ``bed.compare``, ``bed_graph.read`` and ``wig.read_entries``
and ``read`` against the JAX's.
"""

import gzip
import os

import numpy as np
import pytest

from gonomics_tpu.cli import bed_distance_from_chr_ends as jdist_ends
from gonomics_tpu.cli import bed_filter as jbed_filter
from gonomics_tpu.cli import bed_graph_to_wig as jbed_graph_to_wig
from gonomics_tpu.cli import bed_math as jbed_math
from gonomics_tpu.cli import bed_minimum_distance_name as jmin_dist
from gonomics_tpu.cli import bed_overlap_by_window as jby_window
from gonomics_tpu.cli import bed_shear as jbed_shear
from gonomics_tpu.cli import bed_similarity as jbed_similarity
from gonomics_tpu.cli import bed_split as jbed_split
from gonomics_tpu.cli import bed_trim as jbed_trim
from gonomics_tpu.cli import bed_value_wig as jbed_value_wig
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import bed_graph as jbed_graph
from gonomics_tpu.io import wig as jwig
from gonomics_tpu_torch.cli import bed_distance_from_chr_ends as dist_ends
from gonomics_tpu_torch.cli import bed_filter, bed_graph_to_wig, bed_math
from gonomics_tpu_torch.cli import bed_minimum_distance_name as min_dist
from gonomics_tpu_torch.cli import bed_overlap_by_window as by_window
from gonomics_tpu_torch.cli import bed_shear, bed_similarity, bed_split
from gonomics_tpu_torch.cli import bed_trim, bed_value_wig
from gonomics_tpu_torch.io import bed, bed_graph, wig

TOOLS = {"bedFilter": (jbed_filter.main, bed_filter.main),
         "bedMath": (jbed_math.main, bed_math.main),
         "bedSplit": (jbed_split.main, bed_split.main),
         "bedShear": (jbed_shear.main, bed_shear.main),
         "bedTrim": (jbed_trim.main, bed_trim.main),
         "bedDistanceFromChrEnds": (jdist_ends.main, dist_ends.main),
         "bedMinimumDistanceName": (jmin_dist.main, min_dist.main),
         "bedSimilarity": (jbed_similarity.main, bed_similarity.main),
         "bedOverlapByWindow": (jby_window.main, by_window.main),
         "bedValueWig": (jbed_value_wig.main, bed_value_wig.main),
         "bedGraphToWig": (jbed_graph_to_wig.main, bed_graph_to_wig.main)}

SIZES = [("chr1", 3000), ("chr2", 1500), ("chr10", 800)]


def _both(tmp_path, tool: str, argv) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits and the files they wrote
    (under d, at any depth; .gz decompressed) equal; returns the port's
    {relative path: bytes}, or its exit: the SystemExit's message, or the
    type and message of any other exception."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        try:
            main(argv(str(d)))
            exit_msg = None
        except SystemExit as e:
            exit_msg = str(e)
        except Exception as e:  # the JAX tools' ValueError, KeyError, ...
            exit_msg = f"{type(e).__name__}: {e}"
        files = {}
        for root, _, names in os.walk(d):
            for n in names:
                path = os.path.join(root, n)
                opener = gzip.open if n.endswith(".gz") else open
                with opener(path, "rb") as f:
                    files[os.path.relpath(path, d)] = f.read()
        seen[side] = (exit_msg, files)
    assert seen["port"] == seen["jax"]
    exit_msg, files = seen["port"]
    return exit_msg if exit_msg is not None else files


def _write(path, lines) -> str:
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in lines)
    return str(path)


def _records(rng, n: int, fields: int, names=None) -> list[list[str]]:
    """n records of the given field count over SIZES: some empty, some
    repeated, names numeric unless names is given."""
    out = []
    for i in range(n):
        if out and rng.random() < 0.08:
            out.append(list(out[int(rng.integers(0, len(out)))]))
            continue
        c, size = SIZES[int(rng.integers(0, len(SIZES)))]
        start = int(rng.integers(0, size - 320))
        length = 0 if rng.random() < 0.05 else int(rng.integers(1, 320))
        name = (f"{rng.random() * 4 - 1:.3f}" if names is None
                else str(rng.choice(names)))
        rec = [c, str(start), str(start + length), name,
               str(int(rng.integers(0, 1000))), str(rng.choice(["+", "-"])),
               f"{rng.random():.4f}", str(rng.choice(["x", "y"]))]
        out.append(rec[:fields])
    return out


def _string_sorted(recs):
    return sorted(recs, key=lambda r: (r[0], int(r[1]), int(r[2])))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bed_tools")
    rng = np.random.default_rng(2500)
    f = {"sizes": _write(tmp / "t.sizes", [f"{c}\t{n}" for c, n in SIZES])}
    recs = _records(rng, 90, 8)
    f["r8"] = _write(tmp / "r8.bed", ["\t".join(r) for r in recs])
    for k in (3, 4, 6):
        f[f"r{k}"] = _write(tmp / f"r{k}.bed",
                            ["\t".join(r[:k]) for r in recs])
    f["named"] = _write(tmp / "named.bed", ["\t".join(r) for r in _records(
        rng, 40, 6, ["geneA", "fam/1", "fam/2", "x"])])
    # bedMath: A sorted by string, B a shuffled-name subset plus others
    a = _string_sorted(_records(rng, 60, 4))
    f["math_a"] = _write(tmp / "math_a.bed", ["\t".join(r) for r in a])
    b = [list(r) for r in a if rng.random() < 0.6]
    for r in b:
        r[3] = f"{rng.random() * 10 - 2:.2f}"
    b = _string_sorted(b + _records(rng, 20, 4))
    f["math_b"] = _write(tmp / "math_b.bed", ["\t".join(r) for r in b])
    # B in number order (chr2 before chr10): the string-order walk misses
    num = sorted(b, key=lambda r: (int(r[0][3:]), int(r[1]), int(r[2])))
    f["math_b_num"] = _write(tmp / "math_b_num.bed",
                             ["\t".join(r) for r in num])
    zero = [list(r) for r in b]
    in_a = {tuple(r[:3]) for r in a}
    next(r for r in zero[len(zero) // 2:] if tuple(r[:3]) in in_a)[3] = "0"
    f["math_zero"] = _write(tmp / "math_zero.bed",
                            ["\t".join(r) for r in zero])
    f["words"] = _write(tmp / "words.bed", ["chr1\t10\t20\tabc\t5\t+",
                                            "chr1\t30\t40\t1.5\t5\t+"])
    # bedMinimumDistanceName: a genome record a name, on both strands
    genome, inputs = [], []
    for i in range(30):
        c, size = SIZES[i % 3]
        s = int(rng.integers(0, size - 200))
        genome.append(f"{c}\t{s}\t{s + int(rng.integers(1, 200))}\tg{i}\t0\t"
                      + "+-"[i % 2])
        for _ in range(int(rng.integers(1, 4))):
            t = int(rng.integers(0, size - 100))
            inputs.append(f"{c}\t{t}\t{t + int(rng.integers(1, 100))}\tg{i}")
    f["genome"] = _write(tmp / "genome.bed", genome)
    f["inputs"] = _write(tmp / "inputs.bed", inputs)
    f["genome_dot"] = _write(tmp / "genome_dot.bed",
                             [g.rsplit("\t", 1)[0] + "\t." for g in genome])
    f["genome_twice"] = _write(tmp / "genome_twice.bed", genome + genome[:1])
    # bedSimilarity: a second file that overlaps some of r6
    f["other"] = _write(tmp / "other.bed", ["\t".join(r) for r in
                                            _records(rng, 50, 3)])
    f["dups"] = _write(tmp / "dups.bed", ["chr1\t100\t200"] * 3
                       + ["chr1\t500\t600", "chr2\t0\t10"])
    f["list"] = _write(tmp / "list.txt", [f["r6"], f["other"], f["dups"]])
    f["list_twice"] = _write(tmp / "list_twice.txt",
                             [f["r6"], f["other"], f["r6"]])
    # wig: two fixedStep entries a chromosome, a step of 2 on chr2, a
    # value equal to the default, a span; and their failures
    vals = {c: rng.integers(0, 50, n).astype(float) / 4 for c, n in SIZES}
    wig_lines = []
    for c, n in SIZES:
        step = 2 if c == "chr2" else 1
        half = n // 2
        first = vals[c][:half // step]
        wig_lines.append(f"fixedStep chrom={c} start=1 step={step}"
                         + (" span=2" if step == 2 else ""))
        wig_lines += [f"{v:g}" for v in first]
        if c != "chr10":  # chr10's second half stays unset
            wig_lines.append(f"fixedStep chrom={c} start={half + 11} "
                             f"step=1")
            wig_lines += [f"{v:g}" for v in vals[c][half + 10:n]]
    f["wig"] = _write(tmp / "in.wig", wig_lines)
    f["wig_var"] = _write(tmp / "var.wig", ["variableStep chrom=chr1",
                                            "1\t2.0"])
    f["wig_dup"] = _write(tmp / "dup.wig", [
        "fixedStep chrom=chr1 start=1 step=1", "1", "2", "3",
        "fixedStep chrom=chr1 start=3 step=1", "4"])
    f["wig_dup_default"] = _write(tmp / "dup0.wig", [
        "fixedStep chrom=chr1 start=1 step=1", "1", "0", "3",
        "fixedStep chrom=chr1 start=2 step=1", "4"])
    f["wig_long"] = _write(tmp / "long.wig", [
        "fixedStep chrom=chr10 start=799 step=1", "1", "2", "3"])
    f["wig_chrom"] = _write(tmp / "chrom.wig", [
        "fixedStep chrom=chrZ start=1 step=1", "1"])
    f["wig_nohead"] = _write(tmp / "nohead.wig", ["1.5"])
    # bedGraph: disjoint entries, and one pair that overlaps
    bg = []
    for c, n in SIZES:
        edges = np.sort(rng.choice(np.arange(1, n), 12, replace=False))
        for s, e in zip(edges[::2], edges[1::2]):
            bg.append(f"{c}\t{s}\t{e}\t{rng.random() * 9 - 3:.5f}")
    f["bg"] = _write(tmp / "in.bedGraph", bg)
    f["bg_overlap"] = _write(tmp / "overlap.bedGraph",
                             bg + ["chr1\t0\t3000\t1.5"])
    return f


BED_FILTER_CASES = [
    ("r8", []), ("r8", ["-minScore", "200"]), ("r8", ["-maxScore", "700"]),
    ("r8", ["-minLength", "50", "-maxLength", "200"]),
    ("r8", ["-minStart", "300", "-maxStart", "2000"]),
    ("r8", ["-minEnd", "400", "-maxEnd", "1200"]),
    ("r8", ["-minNameFloat", "0.5"]), ("r8", ["-maxNameFloat", "-0.25"]),
    ("r8", ["-minAnnotationFloat", "0.3"]),
    ("r8", ["-maxAnnotationFloat", "0.6", "-annotationFilterField", "0"]),
    ("r8", ["-chrom", "chr2"]),
    ("r8", ["-subSet", "0.5", "-setSeed", "7"]),
    ("r6", ["-subSet", "0.4", "-setSeed", "3", "-chrom", "chr1",
            "-minLength", "10"]),
    ("named", ["-nameEquals", "fam/1"]), ("named", ["-nameNotEquals", "x"]),
    ("r4", ["-maxScore", "999"]), ("r3", ["-minScore", "0"]),
    ("r4", ["-minLength", "1"]),
]


@pytest.mark.parametrize("src,args", BED_FILTER_CASES)
def test_bed_filter(files, tmp_path, src, args):
    got = _both(tmp_path, "bedFilter",
                lambda d: [files[src], f"{d}/out.bed", *args])
    if src in ("r3", "r4") and "-minLength" not in args:
        # a record of 4 fields or fewer fails any score bound that is set
        assert got["out.bed"] == b""
    elif not args or "-maxScore" in args:
        assert got["out.bed"].count(b"\n") > 20


@pytest.mark.parametrize("seed", [0, 7])
def test_bed_filter_sub_set_draws(files, tmp_path, seed):
    """-subSet draws default_rng(setSeed) (not negated, unlike
    vcfFilter's), once for each record that passed every other test."""
    got = _both(tmp_path, "bedFilter", lambda d: [
        files["r6"], f"{d}/out.bed", "-chrom", "chr1", "-subSet", "0.5",
        "-setSeed", str(seed)])
    rng = np.random.default_rng(seed)
    with open(files["r6"]) as fh:
        want = [ln for ln in fh if ln.startswith("chr1\t")
                and rng.random() <= 0.5]
    assert got["out.bed"].decode() == "".join(want)


@pytest.mark.parametrize("src,args,want", [
    ("words", ["-minNameFloat", "0"], "ValueError"),
    ("r6", ["-minAnnotationFloat", "0.1"], "annotationFilterField exceeds"),
    ("r8", ["-maxAnnotationFloat", "0.1", "-annotationFilterField", "2"],
     "annotationFilterField exceeds"),
])
def test_bed_filter_exits(files, tmp_path, src, args, want):
    got = _both(tmp_path, "bedFilter",
                lambda d: [files[src], f"{d}/out.bed", *args])
    assert isinstance(got, str) and want in got


@pytest.mark.parametrize("op", ["add", "Subtract", "times", "divideBy",
                                "plus", "minus", "multiply", "divide"])
def test_bed_math(files, tmp_path, op):
    got = _both(tmp_path, "bedMath", lambda d: [
        files["math_a"], op, files["math_b"], f"{d}/out.bed"])
    a = [tuple(ln.split("\t")[:3]) for ln in
         open(files["math_a"]).read().splitlines()]
    b = {tuple(ln.split("\t")[:3]) for ln in
         open(files["math_b"]).read().splitlines()}
    # only A's records (repeats too) with an exact coordinate match in B
    assert got["out.bed"].count(b"\n") == sum(r in b for r in a) > 0


def test_bed_math_string_order_walk(files, tmp_path):
    """The merge walk orders chroms as strings: B in number order (chr2
    before chr10) loses matches that string order finds."""
    got = _both(tmp_path, "bedMath", lambda d: [
        files["math_a"], "add", files["math_b_num"], f"{d}/out.bed"])
    (tmp_path / "sorted").mkdir()
    bed_math.main([files["math_a"], "add", files["math_b"],
                   str(tmp_path / "sorted" / "out.bed")])
    full = (tmp_path / "sorted" / "out.bed").read_bytes()
    assert 0 < got["out.bed"].count(b"\n") < full.count(b"\n")


@pytest.mark.parametrize("args,want", [
    (["math_a", "divideBy", "math_zero"], "ZeroDivisionError"),
    (["math_a", "modulo", "math_b"], "Unrecognized operation: modulo"),
    (["empty", "add", "math_b"], "First bed file has no bed entries."),
    (["math_a", "add", "empty"], "Second bed file has no bed entries."),
])
def test_bed_math_exits(files, tmp_path, args, want):
    empty = _write(tmp_path / "empty.bed", [])
    got = _both(tmp_path, "bedMath", lambda d: [
        empty if a == "empty" else files.get(a, a) for a in args]
        + [f"{d}/out.bed"])
    assert isinstance(got, str) and want in got


@pytest.mark.parametrize("mode,src", [("byName", "named"),
                                      ("byChrom", "r6"), ("byChrom", "r3")])
@pytest.mark.parametrize("gz", [False, True])
def test_bed_split(files, tmp_path, mode, src, gz):
    got = _both(tmp_path, "bedSplit", lambda d: [
        mode, files[src], f"{d}/split"] + (["-gzipOut"] if gz else []))
    ext = ".bed.gz" if gz else ".bed"
    if mode == "byName":
        # "/" becomes "_" in the file's name and in the name written
        assert sorted(got) == [f"split/{n}{ext}" for n in
                               ("fam_1", "fam_2", "geneA", "x")]
        assert b"fam/" not in b"".join(got.values())
    else:
        assert sorted(got) == sorted(f"split/{c}{ext}" for c, _ in SIZES)


def test_bed_split_bad_mode(files, tmp_path):
    got = _both(tmp_path, "bedSplit",
                lambda d: ["byScore", files["r6"], f"{d}/split"])
    assert "unrecognized mode" in got


@pytest.mark.parametrize("src,size", [("r6", "1"), ("r8", "37"),
                                      ("r3", "500"), ("r4", "0")])
def test_bed_shear(files, tmp_path, src, size):
    got = _both(tmp_path, "bedShear", lambda d: [
        files[src], f"{d}/out.bed", "-fragmentSize", size])
    if size == "0":
        assert "fragmentSize must be a positive integer" in got
    else:
        recs = [ln.split("\t") for ln in
                open(files[src]).read().splitlines()]
        n = int(size)
        assert got["out.bed"].count(b"\n") == sum(
            -(-(int(r[2]) - int(r[1])) // n) for r in recs)


@pytest.mark.parametrize("pct", ["0", "25", "33", "50", "99", "100", "101",
                                 "-1"])
def test_bed_trim(files, tmp_path, pct):
    got = _both(tmp_path, "bedTrim", lambda d: [
        "-trimPercent", pct, files["r6"], f"{d}/out.bed"])
    if int(pct) not in range(0, 101):
        assert "trimPercent must be an integer between 0 and 100" in got


@pytest.mark.parametrize("length,pct,start,end", [
    (10, 25, 2, 9),   # 2.5 rounds to 3: the odd base off the start
    (10, 15, 1, 9),   # 1.5 rounds to 2
    (11, 50, 3, 8),   # 5.5 rounds to 6
    (3, 50, 1, 2),    # 1.5 rounds to 2, one base left
    (7, 10, 1, 7),    # 0.7 rounds to 1, off the start
    (1, 50, None, None),  # 0.5 rounds to 1: length 0, dropped
])
def test_bed_trim_rounds_half_away(tmp_path, length, pct, start, end):
    """Half a base rounds away from zero, an odd removal's extra base
    comes off the start, and a record trimmed to nothing is dropped."""
    src = _write(tmp_path / "one.bed", [f"chr1\t0\t{length}\tn"])
    got = _both(tmp_path, "bedTrim", lambda d: [
        "-trimPercent", str(pct), src, f"{d}/out.bed"])
    want = b"" if start is None else f"chr1\t{start}\t{end}\tn\n".encode()
    assert got["out.bed"] == want


@pytest.mark.parametrize("src", ["r3", "r4", "r6", "r8"])
def test_bed_distance_from_chr_ends(files, tmp_path, src):
    got = _both(tmp_path, "bedDistanceFromChrEnds", lambda d: [
        files[src], files["sizes"], f"{d}/out.bed"])
    sizes = dict(SIZES)
    for ln, want in zip(got["out.bed"].decode().splitlines(),
                        open(files[src]).read().splitlines()):
        c, s, e, *rest = want.split("\t")
        w = ln.split("\t")
        assert int(w[4]) == min(sizes[c] - int(e), int(s))
        assert len(w) == max(5, len(rest) + 3)


@pytest.mark.parametrize("line,want", [
    ("chrZ\t1\t5", "Did not find 'chrZ'"),
    ("chr10\t700\t801", "outside chrom.sizes"),
])
def test_bed_distance_from_chr_ends_exits(files, tmp_path, line, want):
    src = _write(tmp_path / "bad.bed", ["chr1\t1\t5", line])
    got = _both(tmp_path, "bedDistanceFromChrEnds", lambda d: [
        src, files["sizes"], f"{d}/out.bed"])
    assert want in got


def test_bed_minimum_distance_name(files, tmp_path):
    got = _both(tmp_path, "bedMinimumDistanceName", lambda d: [
        files["inputs"], files["genome"], f"{d}/out.bed"])
    genome = {g[3]: g for g in (ln.split("\t") for ln in
                                open(files["genome"]).read().splitlines())}
    lines = got["out.bed"].decode().splitlines()
    assert len(lines) == len(open(files["inputs"]).read().splitlines())
    for ln in lines:
        c, s, e, name, score, strand = ln.split("\t")
        g = genome[name]
        gs, ge = int(g[1]), int(g[2])
        s, e = int(s), int(e)
        dist = 0 if max(s, gs) < min(e, ge) else (
            gs - e + 1 if gs - e >= 0 else s - ge + 1)
        up = s <= gs if g[5] == "+" else e >= ge
        assert (int(score), strand) == (dist, "-" if up else "+")


@pytest.mark.parametrize("genome,inputs,want", [
    ("genome_dot", "inputs", "problem with genomeBed strand"),
    ("genome_twice", "inputs", "found twice in the bed: g0"),
    ("genome", "named", "Did not find genomeBed match for"),
])
def test_bed_minimum_distance_name_exits(files, tmp_path, genome, inputs,
                                         want):
    got = _both(tmp_path, "bedMinimumDistanceName", lambda d: [
        files[inputs], files[genome], f"{d}/out.bed"])
    assert want in got


@pytest.mark.parametrize("pair", [("r6", "other"), ("other", "r8"),
                                  ("dups", "r3"), ("r3", "dups")])
def test_bed_similarity_two(files, tmp_path, pair):
    got = _both(tmp_path, "bedSimilarity", lambda d: [
        files[pair[0]], files[pair[1]], f"{d}/out.txt"])
    assert got["out.txt"].count(b"\n") == 2


def test_bed_similarity_divides_by_duplicates(files, tmp_path):
    """Targets are de-duplicated by coordinates before counting, and the
    count divided by all the targets: dups.bed's three copies of one
    record that overlaps count once, over five."""
    q = _write(tmp_path / "q.bed", ["chr1\t150\t160"])
    got = _both(tmp_path, "bedSimilarity",
                lambda d: [files["dups"], q, f"{d}/out.txt"])
    assert got["out.txt"].decode().splitlines()[1] == \
        f"{1 / 5:f}\t{1:f}\t{0.6:f}"


@pytest.mark.parametrize("src", ["list", "list_twice"])
@pytest.mark.parametrize("matrix", [[], ["-matrixAverage"],
                                    ["-matrixComponents"]])
def test_bed_similarity_list(files, tmp_path, src, matrix):
    got = _both(tmp_path, "bedSimilarity", lambda d: [
        "-list", files[src], f"{d}/out.txt"]
        + ([matrix[0], f"{d}/m.txt"] if matrix else []))
    # three pairs; with a path listed twice, that pair is skipped
    lines = got["out.txt"].decode().splitlines()
    assert len(lines) == 1 + (3 if src == "list" else 2)
    assert ("r6.bed\tr6.bed" in got["out.txt"].decode()) is False


def test_bed_similarity_both_matrices_exit(files, tmp_path):
    got = _both(tmp_path, "bedSimilarity", lambda d: [
        "-list", files["list"], f"{d}/out.txt", "-matrixAverage", "a",
        "-matrixComponents", "b"])
    assert "cannot be used together" in got


def _window_counts(src, sizes, w):
    """The JAX tool's counts, from its own slice loop."""
    counts = {c: np.zeros(n, np.uint32) for c, n in sizes}
    for ln in open(src).read().splitlines():
        c, s, e = ln.split("\t")[:3]
        for p in range(int(s), int(e)):
            counts[c][max(0, p - (w - 1)):p + 1] += 1
    return counts


@pytest.mark.parametrize("src,w", [("r6", "100"), ("r3", "1"),
                                   ("other", "5000"), ("dups", "7"),
                                   ("r8", "0")])
def test_bed_overlap_by_window(files, tmp_path, src, w):
    got = _both(tmp_path, "bedOverlapByWindow", lambda d: [
        files[src], files["sizes"], f"{d}/out.bed", "-windowSize", w])
    lines = got["out.bed"].decode().splitlines()
    # a line a base, in the sizes file's order, windows past the end
    assert len(lines) == sum(n for _, n in SIZES)
    assert lines[2999].split("\t")[:3] == ["chr1", "2999",
                                           str(2999 + int(w))]
    assert lines[3000].startswith("chr2\t0\t")
    counts = _window_counts(files[src], SIZES, int(w))
    assert [int(ln.rsplit("\t", 1)[1]) for ln in lines] == [
        int(v) for c, _ in SIZES for v in counts[c]]


def test_bed_overlap_by_window_odd_records(files, tmp_path):
    """Records past a chromosome's end, reversed, and starting before 0
    (where the JAX's slice stop wraps) give the JAX's counts."""
    src = _write(tmp_path / "odd.bed", [
        "chr10\t790\t900", "chr1\t50\t40", "chr2\t-5\t3", "chr1\t0\t1"])
    got = _both(tmp_path, "bedOverlapByWindow", lambda d: [
        src, files["sizes"], f"{d}/out.bed", "-windowSize", "20"])
    counts = _window_counts(src, SIZES, 20)
    assert [int(ln.rsplit("\t", 1)[1]) for ln in
            got["out.bed"].decode().splitlines()] == [
        int(v) for c, _ in SIZES for v in counts[c]]


def test_bed_overlap_by_window_missing_chrom(files, tmp_path):
    src = _write(tmp_path / "z.bed", ["chr1\t0\t5", "chrZ\t0\t5"])
    got = _both(tmp_path, "bedOverlapByWindow", lambda d: [
        src, files["sizes"], f"{d}/out.bed"])
    assert got == "KeyError: 'chrZ'"


@pytest.mark.parametrize("src", ["r3", "r6", "r8"])
@pytest.mark.parametrize("args", [[], ["-min"], ["-average"],
                                  ["-normalize"],
                                  ["-average", "-normalize"],
                                  ["-noDataValue", "0"],
                                  ["-min", "-noDataValue", "0.25"]])
def test_bed_value_wig(files, tmp_path, src, args):
    got = _both(tmp_path, "bedValueWig", lambda d: [
        files[src], files["wig"], files["sizes"], f"{d}/out.bed", *args])
    lines = got["out.bed"].decode().splitlines()
    assert len(lines) == 90
    # the value is appended as a seventh field or after the annotations
    assert all(len(ln.split("\t")) == (9 if src == "r8" else 7)
               for ln in lines)


def test_bed_value_wig_values(files, tmp_path):
    """The max over a record's range of the wig as read, with the
    default (unset) bases left out, and the largest float64 where none
    is set; go_fmt_g text after a 3-field record raised to 7 fields."""
    got = _both(tmp_path, "bedValueWig", lambda d: [
        files["r3"], files["wig"], files["sizes"], f"{d}/out.bed"])
    w = wig.read(files["wig"], files["sizes"], np.finfo(np.float64).max)
    for ln in got["out.bed"].decode().splitlines():
        c, s, e, name, score, strand, v = ln.split("\t")
        assert (name, score, strand) == ("", "0", ".")
        vals = w[c].values[int(s):int(e)]
        vals = vals[vals != np.finfo(np.float64).max]
        assert float(v) == (vals.max() if len(vals)
                            else np.finfo(np.float64).max)


@pytest.mark.parametrize("wig_file,args,want", [
    ("wig_var", [], "ValueError: variableStep wig unsupported"),
    ("wig_dup", [], "ValueError: multiple wig entries"),
    ("wig_long", [], "ValueError: wig values exceed chrom length"),
    ("wig_chrom", [], "ValueError: chrom chrZ not in chrom sizes"),
    ("wig_nohead", [], "ValueError: wig file missing fixedStep header"),
    ("wig", ["-min", "-average"], "Cannot select both min and average"),
])
def test_bed_value_wig_exits(files, tmp_path, wig_file, args, want):
    got = _both(tmp_path, "bedValueWig", lambda d: [
        files["r3"], files[wig_file], files["sizes"], f"{d}/out.bed", *args])
    assert isinstance(got, str) and got.startswith(want)


def test_bed_value_wig_default_value_is_unset(files, tmp_path):
    """A wig value equal to -noDataValue counts as unset, so a later
    entry may set that base; with the default it is a duplicate."""
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
    dup = _both(tmp_path / "a", "bedValueWig", lambda d: [
        files["r3"], files["wig_dup_default"], files["sizes"],
        f"{d}/out.bed"])
    ok = _both(tmp_path / "b", "bedValueWig", lambda d: [
        files["r3"], files["wig_dup_default"], files["sizes"],
        f"{d}/out.bed", "-noDataValue", "0"])
    assert dup.startswith("ValueError: multiple wig entries")
    assert ok["out.bed"].count(b"\n") == 90


@pytest.mark.parametrize("args", [[], ["-missingData", "-1.5"],
                                  ["-missingData", "0.25"]])
def test_bed_graph_to_wig(files, tmp_path, args):
    got = _both(tmp_path, "bedGraphToWig", lambda d: [
        files["bg"], files["sizes"], f"{d}/out.wig", *args])
    text = got["out.wig"].decode()
    assert text.count("fixedStep") == 18  # six entries a chrom, disjoint
    assert text.index("chr1 ") < text.index("chr10") < text.index("chr2 ")


def test_bed_graph_to_wig_overlap_exits(files, tmp_path):
    got = _both(tmp_path, "bedGraphToWig", lambda d: [
        files["bg_overlap"], files["sizes"], f"{d}/out.wig"])
    assert got == "multiple bedGraph entries map to the same position"


def test_bed_compare_equals_jax(files):
    """bed.compare on every pair of a seeded file's records, and the
    sort it implies, against the JAX's."""
    recs = bed.read(files["r6"])
    jrecs = jbed.read(files["r6"])
    got = [[bed.compare(a, b) for b in recs] for a in recs]
    want = [[jbed.compare(a, b) for b in jrecs] for a in jrecs]
    assert got == want
    assert {v for row in got for v in row} == {-1, 0, 1}


def test_bed_graph_read_write_equals_jax(files, tmp_path):
    got, want = bed_graph.read(files["bg"]), jbed_graph.read(files["bg"])
    assert [vars(r) for r in got] == [vars(r) for r in want]
    bed_graph.write(str(tmp_path / "port.bg"), got)
    jbed_graph.write(str(tmp_path / "jax.bg"), want)
    assert (tmp_path / "port.bg").read_bytes() == \
        (tmp_path / "jax.bg").read_bytes()


@pytest.mark.parametrize("default", [0.0, 0.25])
def test_wig_read_equals_jax(files, default):
    entries, jentries = wig.read_entries(files["wig"]), \
        jwig.read_entries(files["wig"])
    assert [(e.chrom, e.start, e.step, e.span, e.values.tolist())
            for e in entries] == [(e.chrom, e.start, e.step, e.span,
                                   e.values.tolist()) for e in jentries]
    got = wig.read(files["wig"], files["sizes"], default)
    want = jwig.read(files["wig"], files["sizes"], default)
    assert list(got) == list(want)
    for c in want:
        assert got[c].values.tobytes() == want[c].values.tobytes()
        assert got[c].default_value == want[c].default_value
