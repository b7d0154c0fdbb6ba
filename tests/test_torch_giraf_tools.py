"""The port's sortGraph, girafSort and girafCompress
(gonomics_tpu_torch/cli/sort_graph.py, giraf_sort.py, giraf_compress.py)
with ``dna_threebit.py``, ``io/giraf.py`` and ``io/binary_giraf.py``, on
the CPU against the JAX package; and ``chip_smoke.py``'s slice 14a gates
on the JAX tools' files.

The inputs are built here from numpy seeds: a variant graph (SNPs, an
insertion, a deletion) with its node ids shuffled, so that its
topological order is not its id order, and giraf records along random
walks of it: soft clips, =, X, I and D runs, run-length qualities, both
strands and flags with and without bit 8, notes of every binary type.
The three-bit words around the 21-base word boundary and the binary
records' bytes are held bit for bit; the giraf text, girafSort's output
and ``.idx`` at two chunk sizes, sortGraph's graph and girafCompress's
``.fe`` payload and decompressed text byte for byte. The binary format
has no strand column: its reader sets the strand from flag bit 8, so a
round trip turns a '+' record without the bit to '-', as gonomics' does.
"""

import ast
import gzip
import os
import re
import struct

import numpy as np
import pytest

import chip_smoke
from gonomics_tpu import dna as jdna
from gonomics_tpu import dna_threebit as jtb
from gonomics_tpu import graph as jgraph
from gonomics_tpu import native as jnative
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.io import binary_giraf as jbg
from gonomics_tpu.io import giraf as jgiraf
from gonomics_tpu.io.fasta import Fasta as JFasta
from gonomics_tpu.io.vcf import Vcf as JVcf
from gonomics_tpu_torch import dna
from gonomics_tpu_torch import dna_threebit as tb
from gonomics_tpu_torch import graph
from gonomics_tpu_torch import native as tnative
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.io import binary_giraf as bg
from gonomics_tpu_torch.io import giraf
from gonomics_tpu_torch.io.fasta import Fasta
from gonomics_tpu_torch.io.vcf import Vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTES = {
    "none": [],
    "xo": ["XO:Z:~"],
    "typed": ["AB:A:x", "c1:c:-5", "C1:C:200", "s1:s:-300", "S1:S:60000",
              "i1:i:-70000", "I1:I:4000000000", "Z1:Z:hello", "H1:H:1AE3",
              "B1:B:c,1,2"],
    "float": ["f1:f:3.5", "XO:Z:~"],
}


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, IndexError, KeyError,
            struct.error) as e:
        return type(e).__name__, str(e)


def shuffled_graph(seed=3530, n=1500):
    """A JAX variant graph of n random bases with SNPs, an insertion and a
    deletion, its node ids permuted (edges remapped, nodes listed in the
    new id order)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.int8)
    s = jdna.to_string

    def rec(pos, r, a, kind):
        return JVcf(chrom="chr1", pos=pos, id=".", ref=r, alt=[a],
                    info=f"SVTYPE={kind}")

    vcfs = [rec(p, s(ref[p - 1:p]), s((ref[p - 1:p] + 1) % 4), "SNP")
            for p in range(60, n - 60, 90)]
    vcfs += [rec(700, s(ref[699:705]), s(ref[699:700]), "DEL"),
             rec(1001, s(ref[1000:1001]), s(ref[1000:1001]) + "GATTA",
                 "INS")]
    vcfs.sort(key=lambda v: v.pos)
    g = jgraph.variant_graph([JFasta("chr1", ref)], {"chr1": vcfs})
    perm = rng.permutation(len(g.nodes))
    out = jgraph.GenomeGraph(nodes=[None] * len(g.nodes))
    for old, node in enumerate(g.nodes):
        out.nodes[perm[old]] = jgraph.Node(
            id=int(perm[old]), seq=node.seq,
            prev=[jgraph.Edge(int(perm[e.dest]), e.prob) for e in node.prev],
            next=[jgraph.Edge(int(perm[e.dest]), e.prob) for e in node.next])
    return out


def _merge(runs):
    out = []
    for n, op in runs:
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + n, op)
        else:
            out.append((n, op))
    return out


def walk_record(rng, g, name, notes):
    """A giraf line along a random walk of g: an optional soft clip at
    each end, = runs, single-base X, 1-3 base I and D; run-length
    qualities; a seeded flag and strand."""
    starts = [nd.id for nd in g.nodes if len(nd.seq)]
    node = g.nodes[int(rng.choice(starts))]
    t0 = int(rng.integers(0, len(node.seq)))
    path, ref = [node.id], list(node.seq[t0:])
    while len(ref) < 160 and node.next:
        node = g.nodes[node.next[int(rng.integers(len(node.next)))].dest]
        path.append(node.id)
        ref += list(node.seq)
    runs, read, t = [], [], 0

    def clip():
        k = int(rng.integers(1, 5))
        runs.append((k, "S"))
        read.extend(rng.integers(0, 4, k))

    if rng.random() < 0.3:
        clip()
    limit = min(len(ref), int(rng.integers(40, 130)))
    while t < limit:
        r = rng.random()
        if r < 0.1:
            runs.append((1, "X"))
            read.append((ref[t] + int(rng.integers(1, 4))) % 4)
            t += 1
        elif r < 0.16 and runs:
            k = int(rng.integers(1, 4))
            runs.append((k, "I"))
            read.extend(rng.integers(0, 4, k))
        elif r < 0.21 and runs and runs[-1][1] == "=":
            k = min(int(rng.integers(1, 4)), limit - t)
            runs.append((k, "D"))
            t += k
        else:
            k = min(int(rng.integers(1, 16)), limit - t)
            runs.append((k, "="))
            read.extend(ref[t:t + k])
            t += k
    if rng.random() < 0.3:
        clip()
    runs = _merge(runs)
    used, left = [], t0 + t
    for nid in path:
        used.append(nid)
        if left <= len(g.nodes[nid].seq):
            break
        left -= len(g.nodes[nid].seq)
    seq = dna.to_string(np.asarray(read, np.int8))
    qual = np.repeat(rng.integers(2, 41, len(seq)),
                     rng.integers(1, 6, len(seq)))[:len(seq)]
    lead = runs[0][0] if runs[0][1] == "S" else 0
    tail = runs[-1][0] if runs[-1][1] == "S" else 0
    flag = int(rng.choice([0, 4, 8, 12, 16, 24]))
    strand = "+" if rng.random() < 0.5 else "-"
    cig = "".join(f"{n}{op}" for n, op in runs)
    cols = [name, str(lead), str(len(seq) - 1 - tail), str(flag), strand,
            f"{t0}:{'>'.join(map(str, used))}:{left}", cig,
            str(int(rng.integers(-500, 20000))), str(int(rng.integers(0, 256))),
            seq, "".join(chr(33 + int(q)) for q in qual)] + notes
    return "\t".join(cols)


def carried(line: str, g) -> bool:
    """chip_smoke's rule: the binary format gives the read back."""
    w = line.split("\t")
    t0, path, _ = w[5].split(":")
    seqs = [jdna.to_string(g.nodes[int(n)].seq) for n in path.split(">")]
    runs = [(int(n), op) for n, op in re.findall(r"(\d+)(\D)", w[6])]
    return chip_smoke.rebuilt_read(runs, w[9], seqs, int(t0)) == w[9]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("giraf")
    g = shuffled_graph()
    jgraph.write(str(d / "s.gg"), g)
    rng = np.random.default_rng(3531)
    kinds = list(NOTES)
    lines = [walk_record(rng, g, f"q{i}", NOTES[kinds[i % len(kinds)]])
             for i in range(160)]
    keep = [ln for ln in lines if carried(ln, g) and "f1:f" not in ln]
    unmapped = "u0\t0\t0\t6\t+\t0::0\t*\t0\t255\tACGTNACGT\t+++++++++\tXO:Z:~"
    match = keep[0].split("\t")
    match[6] = match[6].replace("=", "M").replace("X", "M")
    out = {"g": g, "lines": lines, "keep": keep}
    for name, rows in (("w.giraf", lines), ("keep.giraf", keep),
                       ("unmapped.giraf", lines[:5] + [unmapped]),
                       ("m.giraf", ["\t".join(match)])):
        (d / name).write_text("".join(ln + "\n" for ln in rows))
    out.update({k: str(d / k) for k in ("s.gg", "w.giraf", "keep.giraf",
                                        "unmapped.giraf", "m.giraf")})
    return out


JAX_PUBLIC = ["dna_threebit.py", "io/giraf.py", "io/binary_giraf.py",
              "cli/sort_graph.py", "cli/giraf_compress.py",
              "cli/giraf_sort.py"]


def _names(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("rel", JAX_PUBLIC)
def test_module_defines_the_jax_public_names(rel):
    """Each module defines every public name of its JAX file."""
    assert _names(os.path.join(REPO, "gonomics_tpu", rel)) <= \
        _names(os.path.join(REPO, "gonomics_tpu_torch", rel))


def test_fixture_records_cover_the_cases(files):
    """The walks give X, I, D and S runs, both strands, flags with and
    without bit 8, and records the binary format carries."""
    cols = [ln.split("\t") for ln in files["lines"]]
    for op in "XIDS=":
        assert any(op in w[6] for w in cols)
    assert {w[4] for w in cols} == {"+", "-"}
    assert {int(w[3]) & 8 for w in cols} == {0, 8}
    assert 60 < len(files["keep"]) < len(files["lines"])


@pytest.mark.parametrize("padding", [0, 5, 6], ids=["A", "pad1", "pad2"])
@pytest.mark.parametrize("n", [1, 20, 21, 22, 41, 42, 43, 63])
def test_three_bit_words(n, padding):
    """new_three_bit's words (bit for bit, uint64), bases_to_uint64 of
    each word's bases, every base back, ranges and the string forms equal
    the JAX's around the 21-base word boundary."""
    seq = np.random.default_rng(n * 7 + padding).integers(0, 5, n).astype(
        np.int8)
    got, want = tb.new_three_bit(seq, padding), jtb.new_three_bit(seq, padding)
    assert got.seq.dtype == want.seq.dtype == np.uint64
    assert got.seq.tobytes() == want.seq.tobytes() and got.len == want.len
    for s in range(0, n, 21):
        e = min(s + 21, n)
        w = tb.bases_to_uint64(seq, s, e, padding)
        assert w == jtb.bases_to_uint64(seq, s, e, padding)
        assert isinstance(w, int) and w == int(got.seq[s // 21])
    assert [tb.get_base(got, i) for i in range(n)] == \
        [jtb.get_base(want, i) for i in range(n)] == seq.tolist()
    for s, e in ((0, n), (n // 2, n), (0, max(1, n // 3))):
        assert tb.range_to_dna_bases(got, s, e).tobytes() == \
            jtb.range_to_dna_bases(want, s, e).tobytes()
    assert tb.to_string(got) == jtb.to_string(want)
    text = jdna.to_string(seq).lower()
    assert tb.from_string(text).seq.tobytes() == \
        jtb.from_string(text).seq.tobytes()


@pytest.mark.parametrize("n", [20, 21, 22, 42, 43])
def test_three_bit_append_cat_copy(n):
    """append (base by base from None), cat and copy give the JAX's words
    and lengths; out-of-range calls give its errors."""
    seq = np.random.default_rng(n).integers(0, 5, n).astype(np.int8)
    a = b = None
    for x in seq:
        a, b = tb.append(a, int(x)), jtb.append(b, int(x))
        assert a.seq.tobytes() == b.seq.tobytes() and a.len == b.len
    c, d = tb.copy(a), jtb.copy(b)
    tb.cat(c, tb.from_string("ACGTN" * 5))
    jtb.cat(d, jtb.from_string("ACGTN" * 5))
    assert c.seq.tobytes() == d.seq.tobytes() and c.len == d.len
    assert a.len == n and tb.copy(None) is None
    tb.cat(c, None)
    assert c.len == n + 25
    for fn, args in (("bases_to_uint64", (seq, 0, 22, 0)),
                     ("bases_to_uint64", (seq, 3, 3, 0)),
                     ("get_three_bit_base", (a, n)),
                     ("get_three_bit_base", (a, -1)),
                     ("range_to_dna_bases", (a, 0, n + 1)),
                     ("range_to_dna_bases", (a, 4, 4))):
        jargs = tuple(b if x is a else x for x in args)
        assert _outcome(getattr(tb, fn), *args) == \
            _outcome(getattr(jtb, fn), *jargs)


def test_encode_giraf_bytes(files):
    """encode_giraf's bytes (with and without notes, both strands, an
    unmapped record) and its helpers' values equal the JAX's; its errors
    too."""
    tlines = [giraf.process_giraf_line(ln) for ln in
              files["lines"] + open(files["unmapped.giraf"]).read()
              .splitlines()[-1:]]
    jlines = [jgiraf.process_giraf_line(ln) for ln in
              files["lines"] + open(files["unmapped.giraf"]).read()
              .splitlines()[-1:]]
    for t, j in zip(tlines, jlines):
        assert bg.encode_giraf(t) == jbg.encode_giraf(j)
        assert bg._encode_qual(t.qual) == jbg._encode_qual(j.qual)
        ft, fj = bg._get_fancy_seq(t.seq, t.cigar), jbg._get_fancy_seq(
            j.seq, j.cigar)
        assert ft.seq.tobytes() == fj.seq.tobytes() and ft.len == fj.len
    assert len({bg.encode_giraf(t)[4:] for t in tlines}) == len(tlines)
    for tag, typ, value in (("ABC", "Z", "x"), ("AB", "q", "1"),
                            ("AB", "c", "300")):
        assert _outcome(bg._note_to_bytes, giraf.Note(tag, typ, value)) == \
            _outcome(jbg._note_to_bytes, jgiraf.Note(tag, typ, value))
    long_t, long_j = tlines[0], jlines[0]
    long_t.qname = long_j.qname = "q" * 256
    assert _outcome(bg.encode_giraf, long_t) == \
        _outcome(jbg.encode_giraf, long_j)


def test_giraf_text_read_write(files, tmp_path):
    """read then write gives the JAX's bytes, which are the input's."""
    for side, mod in (("jax", jgiraf), ("port", giraf)):
        mod.write(str(tmp_path / side), mod.read(files["w.giraf"]))
    assert (tmp_path / "port").read_bytes() == \
        (tmp_path / "jax").read_bytes() == open(files["w.giraf"], "rb").read()


@pytest.mark.parametrize("line", [
    "a\t0\t1\t0\t+\t0:1:2\t3=\t5\t255\tACG",
    "a\t0\t1\t0\t+\t0:1\t3=\t5\t255\tACG\tIII",
    "a\t0\t1\t0\t+\t0:1>x:2\t3=\t5\t255\tACG\tIII",
    "a\t0\t1\t0\t+\t0::2\t3=\t5\t255\tACG\tIII\tXO",
    "a\t0\t1\t0\t-\t0:1:2\t3=\t5\t255\tACG\tIII\tAB:i:4\tCD:Z:x:y"])
def test_giraf_line_parse(line):
    """process_giraf_line's record or error equals the JAX's."""
    got, want = _outcome(giraf.process_giraf_line, line), _outcome(
        jgiraf.process_giraf_line, line)
    if got[0] == "ok":
        got, want = giraf.to_string(got[1]), jgiraf.to_string(want[1])
    assert got == want


def _run_both(tmp_path, capsys, argv, patch=None):
    """Both umbrellas with argv(d), each in a directory of its own;
    returns {side: (outcome, {file: bytes}, stdout)}."""
    got = {}
    for side, umbrella in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir()
        res = _outcome(umbrella.main, argv(str(d)))
        files = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
        got[side] = (res, files, capsys.readouterr().out)
    return got


def test_sort_graph_equals_jax(files, tmp_path, capsys):
    """sortGraph of the shuffled DAG: the JAX's bytes, every edge then
    pointing forward."""
    got = _run_both(tmp_path, capsys, lambda d: [
        "sortGraph", files["s.gg"], os.path.join(d, "sorted.gg")])
    assert got["port"] == got["jax"]
    path = str(tmp_path / "port" / "sorted.gg")
    _, edges = chip_smoke.gg_text(path)
    assert edges and all(u < v for u, v in edges)
    _, before = chip_smoke.gg_text(files["s.gg"])
    assert any(u > v for u, v in before)


@pytest.mark.parametrize("chunk", [7, 1_000_000])
def test_giraf_sort_equals_jax(files, tmp_path, capsys, chunk):
    """girafSort's text and .idx equal the JAX's byte for byte, with the
    merge over 23 chunks and over one; the lines are the input's, in
    nondecreasing (first rank, start, ranks) order."""
    got = _run_both(tmp_path, capsys, lambda d: [
        "girafSort", files["w.giraf"], files["s.gg"],
        os.path.join(d, "out.giraf"), "-chunkSize", str(chunk)])
    assert got["port"] == got["jax"]
    res, out, _ = got["port"]
    assert res[0] == "ok" and set(out) == {"out.giraf", "out.giraf.idx"}
    idx = [int(x) for x in out["out.giraf.idx"].split()]
    rank = {n: i for i, n in enumerate(idx)}
    lines = out["out.giraf"].decode().splitlines()
    assert sorted(lines) == sorted(files["lines"])
    keys = []
    for ln in lines:
        t0, path, _ = ln.split("\t")[5].split(":")
        r = [rank[int(n)] for n in path.split(">")]
        keys.append((r[0], int(t0), tuple(r[1:])))
    assert keys == sorted(keys)


def test_giraf_sort_unmapped_record(files, tmp_path, capsys):
    """A record with no path node gives the JAX's IndexError, as
    gonomics' sort indexes its first node."""
    got = _run_both(tmp_path, capsys, lambda d: [
        "girafSort", files["unmapped.giraf"], files["s.gg"],
        os.path.join(d, "out.giraf"), "-chunkSize", "2"])
    assert got["port"][0] == got["jax"][0] and got["port"][0][0] == \
        "IndexError"


@pytest.mark.parametrize("deflate", ["zlib", "default"])
@pytest.mark.parametrize("src", ["w.giraf", "keep.giraf"])
def test_giraf_compress_round_trip(files, tmp_path, capsys, monkeypatch,
                                   deflate, src):
    """girafCompress's .fe equals the JAX's: its gunzipped record stream
    always, its compressed bytes where both deflate alike (zlib forced in
    both, or both through the host library); then -decompress gives the
    JAX's text, which for the records the format carries is the input's
    but for the strand column, which follows flag bit 8."""
    if deflate == "zlib":
        monkeypatch.setattr(jnative, "compress_blocks", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "compress_blocks", lambda *a, **k: None)
    same_path = ((jnative.compress_blocks(b"x", bgzf=True) is None)
                 == (tnative.compress_blocks(b"x", bgzf=True) is None))

    def argv(d):
        path = os.path.join(d, "in.giraf")
        with open(files[src]) as fh, open(path, "w") as out:
            out.write(fh.read())
        return ["girafCompress", path]

    got = _run_both(tmp_path, capsys, argv)
    fe = {side: v[1]["in.giraf.fe"] for side, v in got.items()}
    assert gzip.decompress(fe["port"]) == gzip.decompress(fe["jax"])
    assert same_path and fe["port"] == fe["jax"]
    assert len(fe["port"]) < os.path.getsize(files[src])
    back = {}
    for side, umbrella in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        os.remove(d / "in.giraf")
        res = _outcome(umbrella.main, ["girafCompress", str(d / "in.giraf.fe"),
                                       "-decompress", "-ref", files["s.gg"]])
        out = d / "in.giraf"
        back[side] = (res, out.read_text() if out.exists() else None)
    assert back["port"] == back["jax"]
    back = back["port"][1]
    if src == "keep.giraf":
        want = []
        for ln in files["keep"]:
            w = ln.split("\t")
            w[4] = "+" if int(w[3]) & 8 else "-"
            want.append("\t".join(w))
        assert back.splitlines() == want


@pytest.mark.parametrize("argv", [
    ["@w.giraf.fe", "-decompress"], ["@w.giraf", "-decompress", "-ref", "g"],
    ["@w.fa"], ["@m.giraf.fe", "-decompress", "-ref", "@s.gg"],
    ["@u.giraf.fe", "-decompress", "-ref", "@s.gg"]],
    ids=["no_ref", "no_fe", "not_giraf", "m_ops", "unmapped"])
def test_giraf_compress_exits(files, tmp_path, capsys, argv):
    """girafCompress's exits equal the JAX's: no -ref, no .fe, no .giraf;
    decompressing a record with M runs or an unmapped one raises the
    JAX's ValueError, as gonomics' reader knows neither."""
    for name, src in (("m.giraf", files["m.giraf"]),
                      ("u.giraf", files["unmapped.giraf"])):
        path = str(tmp_path / name)
        with open(src) as fh, open(path, "w") as out:
            out.write(fh.read())
        tmain.main(["girafCompress", path])
    paths = {"w.giraf.fe": files["w.giraf"] + ".fe",
             "w.giraf": files["w.giraf"], "w.fa": "x.fa",
             "m.giraf.fe": str(tmp_path / "m.giraf.fe"),
             "u.giraf.fe": str(tmp_path / "u.giraf.fe"),
             "s.gg": files["s.gg"]}
    args = [paths[a[1:]] if a.startswith("@") else a for a in argv]
    got = {side: _outcome(m.main, ["girafCompress", *args])
           for side, m in (("jax", jmain), ("port", tmain))}
    assert got["port"] == got["jax"] and got["port"][0] != "ok"


def small_tools_inputs(d, seed=3532, n=6000, reads=80):
    """What giraf_pfa_inputs reads, at a small size: t.fa (chr1 of n
    random bases and a short chr2); aln.fa (chr1's target and a query with
    a SNP every 97 bases, an insertion and a deletion); c.vcf (chr1's
    SNPs, an indel, a chr2 SNP); v.gg (a variant graph of every third
    SNP, the port's writer); g.giraf (the port's host aligner on the CPU
    over reads of the query, every other reverse-complemented, one
    random)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, n).astype(np.int8)
    snp = np.arange(50, n - 50, 97)
    q = t.copy()
    q[snp] = (t[snp] + rng.integers(1, 4, len(snp))) % 4
    ts, qs = dna.to_string(t), dna.to_string(q)
    ins = dna.to_string(rng.integers(0, 4, 7).astype(np.int8))
    t_row = ts[:4500] + "-" * 7 + ts[4500:]
    q_row = qs[:4500] + ins + qs[4500:5200] + "-" * 5 + qs[5205:]
    q_seq = q_row.replace("-", "")
    chr2 = dna.to_string(rng.integers(0, 4, 1000).astype(np.int8))
    p = {k: os.path.join(d, k) for k in ("t.fa", "aln.fa", "c.vcf", "v.gg",
                                         "g.fq", "g.giraf")}
    with open(p["t.fa"], "w") as fh:
        for name, s in (("chr1", ts), ("chr2", chr2)):
            fh.write(f">{name}\n" + "".join(s[i:i + 60] + "\n"
                                            for i in range(0, len(s), 60)))
    with open(p["aln.fa"], "w") as fh:
        fh.write(f">Target\n{t_row}\n>Query\n{q_row}\n")
    sites = [(int(c) + 1, ts[c], qs[c]) for c in snp]
    with open(p["c.vcf"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        fh.writelines(f"chr1\t{pos}\t.\t{r}\t{a}\t.\t.\t.\n"
                      for pos, r, a in sites)
        fh.write(f"chr1\t5200\t.\t{ts[5199:5205]}\t{ts[5199]}\t.\t.\t.\n")
        fh.write(f"chr2\t10\t.\t{chr2[9]}\tA\t.\t.\t.\n")
    vcfs = [Vcf(chrom="chr1", pos=pos, id=".", ref=r, alt=[a],
                info="SVTYPE=SNP") for pos, r, a in sites[::3]]
    graph.write(p["v.gg"], graph.variant_graph([Fasta("chr1", t)],
                                               {"chr1": vcfs}))
    with open(p["g.fq"], "w") as fh:
        for i in range(reads):
            s = int(rng.integers(0, len(q_seq) - 150))
            r = q_seq[s:s + 150]
            if i % 2:
                r = r[::-1].translate(str.maketrans("ACGT", "TGCA"))
            if i == 3:
                r = dna.to_string(rng.integers(0, 4, 150).astype(np.int8))
            fh.write(f"@r{i}\n{r}\n+\n{'I' * 150}\n")
    tmain.main(["gsw", "align", p["v.gg"], p["g.fq"], "-o", p["g.giraf"],
                "--device", "cpu"])
    return p


def test_giraf_pfa_checks_pass_on_jax_outputs(tmp_path):
    """chip_smoke's giraf_pfa_checks read the files that the JAX tools
    write from giraf_pfa_inputs at a small size (girafSort in chunks of
    16), and every gate holds."""
    p = small_tools_inputs(str(tmp_path))
    gp = chip_smoke.giraf_pfa_inputs(
        str(tmp_path), p["g.giraf"], p["v.gg"], p["t.fa"], p["c.vcf"],
        p["aln.fa"], chunk=16, soft_cols=6000)

    def step(name, *argv):
        jmain.main(list(argv))

    chip_smoke.giraf_pfa_steps(step, gp)
    x = chip_smoke.giraf_pfa_checks(gp)
    assert chip_smoke.giraf_pfa_ok(x), x
    ff = x["pfa_find_fast"]
    assert ff["clean_windows"] < ff["windows"]
    assert x["giraf_sort"]["unmapped_left_out"] >= 1
