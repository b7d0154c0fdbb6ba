"""The port's girafSimulate, multFaVisualizer, multFaVisualizeBeds,
faChunkAlign and faDrawAlnChunks (gonomics_tpu_torch/cli/) with
``graph.py``'s random giraf block, ``browser.multi_fa_visualizer``,
``align/multi.py``'s chunk alignment and ``align/draw.py``, on the CPU
against the JAX package; and ``chip_smoke.py``'s slice 14b/15a gates on
the JAX tools' files.

The inputs are built here from numpy seeds: a variant graph with N runs,
SNPs, an insertion and a deletion; multiFa alignments with gaps in every
row, lower-case runs and names of several lengths; records made of
10-base chunks with whole-chunk indels. Files are held byte for byte,
PNGs pixel for pixel and byte for byte, exceptions by type and message,
and the Go generators by ``_v``, ``tap`` and ``feed`` after each call.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from gonomics_tpu import browser as jbrowser
from gonomics_tpu import dna as jdna
from gonomics_tpu import graph as jgraph
from gonomics_tpu.align import matrices as jmatrices
from gonomics_tpu.align import multi as jmulti
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.io.fasta import Fasta as JFasta
from gonomics_tpu.io.vcf import Vcf as JVcf
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu_torch import browser
from gonomics_tpu_torch import dna
from gonomics_tpu_torch import graph
from gonomics_tpu_torch.align import matrices
from gonomics_tpu_torch.align import multi
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.io import giraf
from gonomics_tpu_torch.io.fasta import Fasta
from gonomics_tpu_torch.numbers import gorand as tgr

from test_torch_giraf_tools import small_tools_inputs
from test_torch_pfa_tools import _names
from test_torch_popgen_tools import _Recorded


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, IndexError, ZeroDivisionError) as e:
        return type(e).__name__, str(e)


def _files(d):
    """{relative path: bytes} of every file under d."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


def _both(tmp_path, argv_of, capsys=None):
    """Each umbrella's outcome, files and stdout on argv_of(side dir)."""
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir()
        res = _outcome(mod.main, argv_of(str(d)))
        printed = capsys.readouterr().out if capsys else None
        out[side] = (res[0], res[1] if res[0] != "ok" else None,
                     _files(d), printed)
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PUBLIC = {
    "graph.py": {"bases_in_graph", "rand_location_fast", "rand_path_fwd",
                 "rand_giraf", "node_pos_to_read_pos",
                 "rand_somatic_mutations"},
    **{rel: None for rel in (
        "browser.py", "align/multi.py", "align/draw.py", "lastz_writer.py",
        "cli/giraf_simulate.py", "cli/mult_fa_visualizer.py",
        "cli/mult_fa_visualize_beds.py", "cli/fa_chunk_align.py",
        "cli/fa_draw_aln_chunks.py", "cli/last_z_writer.py",
        "cli/format_ideogram.py", "cli/slurm_check.py")}}


@pytest.mark.parametrize("rel", sorted(JAX_PUBLIC))
def test_module_defines_the_jax_public_names(rel):
    """Each module of slices 14b and 15a defines every public name of its
    JAX file (graph.py those of the random giraf block)."""
    want = JAX_PUBLIC[rel] or _names(os.path.join(REPO, "gonomics_tpu", rel))
    assert want <= _names(os.path.join(REPO, "gonomics_tpu_torch", rel))


# --- girafSimulate ---

@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    """A JAX variant graph of 1,500 seeded bases with two N runs, a SNP
    every 70 bases, a 6-base deletion and a 5-base insertion, written by
    the JAX writer."""
    rng = np.random.default_rng(3601)
    n = 1500
    ref = rng.integers(0, 4, n).astype(np.int8)
    ref[300:312] = jdna.N
    ref[1100:1103] = jdna.N
    s = jdna.to_string

    def rec(pos, r, a, kind):
        return JVcf(chrom="chr1", pos=pos, id=".", ref=r, alt=[a],
                    info=f"SVTYPE={kind}")

    vcfs = [rec(p, s(ref[p - 1:p]), s((ref[p - 1:p] + 1) % 4), "SNP")
            for p in range(40, n - 40, 70) if ref[p - 1] != jdna.N]
    vcfs += [rec(601, s(ref[600:607]), s(ref[600:601]), "DEL"),
             rec(901, s(ref[900:901]), s(ref[900:901]) + "GATTA", "INS")]
    vcfs.sort(key=lambda v: v.pos)
    g = jgraph.variant_graph([JFasta("chr1", ref)], {"chr1": vcfs})
    path = str(tmp_path_factory.mktemp("sim_graph") / "g.gg")
    jgraph.write(path, g)
    return path


SIM_CASES = {  # numReads, readLen, seed, somaticSNV, somaticAF
    "short": (30, 20, 1, 0, 0.2),
    "crossing": (40, 90, 7, 0, 0.2),
    "somatic": (60, 40, 11, 6, 0.5),
    "somatic_every_read": (50, 60, 3, 10, 1.0),
    "somatic_af_zero": (40, 30, 5, 4, 0.0),
    "long_reads": (20, 300, 2, 3, 0.7),
    "no_reads": (0, 50, 4, 2, 0.5),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_giraf_simulate_equal_jax(graph_file, tmp_path, monkeypatch, case):
    """girafSimulate through each umbrella writes the same giraf bytes, and
    each Go generator it made ends in the same state."""
    n, length, seed, snv, af = SIM_CASES[case]
    rec = _Recorded(monkeypatch)
    out = _both(tmp_path, lambda d: [
        "girafSimulate", graph_file, d + "/sim.giraf", "-numReads", str(n),
        "-readLen", str(length), "-seed", str(seed), "-somaticSNV", str(snv),
        "-somaticAF", str(af)])
    assert out["port"] == out["jax"]
    assert rec.states("port") == rec.states("jax")
    assert len(rec.states("jax")) == (2 if snv else 1)
    lines = out["jax"][2]["sim.giraf"].decode().splitlines()
    assert len(lines) == n
    if n:
        strands = {ln.split("\t")[4] for ln in lines}
        assert strands == {"+", "-"}
        assert all("N" not in ln.split("\t")[9] for ln in lines)


def test_giraf_simulate_too_long_read(graph_file, tmp_path):
    """A read longer than the graph's bases exits alike."""
    out = _both(tmp_path, lambda d: [
        "girafSimulate", graph_file, d + "/sim.giraf", "-readLen", "5000"])
    assert out["port"] == out["jax"]
    assert out["jax"][0] == "SystemExit"


def _graphs(graph_file):
    return jgraph.read(graph_file), graph.read(graph_file)


def _giraf_text(records):
    return [giraf.to_string(r) for r in records]


@pytest.mark.parametrize("seed", [1, 8, 21])
def test_rand_giraf_and_mutations_equal_jax(graph_file, monkeypatch, seed):
    """rand_giraf's records, rand_somatic_mutations' locations and records,
    and the generators' states after each are the JAX's; the reads cross
    node edges on both strands, and the mutations change bases."""
    from gonomics_tpu.io import giraf as jgiraf

    jg, tg = _graphs(graph_file)
    rec = _Recorded(monkeypatch)
    jr = jgraph.rand_giraf(jg, 80, 70, seed)
    tr = graph.rand_giraf(tg, 80, 70, seed)
    assert rec.states("port") == rec.states("jax")
    clean = [jgiraf.to_string(r) for r in jr]
    assert _giraf_text(tr) == clean
    assert any(len(r.path.nodes) > 1 for r in tr)
    assert {r.pos_strand for r in tr} == {True, False}
    jm = jgraph.rand_somatic_mutations(jg, jr, 12, 0.6, seed)
    tm = graph.rand_somatic_mutations(tg, tr, 12, 0.6, seed)
    assert tm == jm
    assert rec.states("port") == rec.states("jax")
    assert _giraf_text(tr) == [jgiraf.to_string(r) for r in jr]
    assert _giraf_text(tr) != clean


def test_node_pos_to_read_pos_equal_jax(graph_file):
    """node_pos_to_read_pos at every node of every read's path, and at a
    node off the path, is the JAX's."""
    jg, tg = _graphs(graph_file)
    jr = jgraph.rand_giraf(jg, 30, 120, 13)
    tr = graph.rand_giraf(tg, 30, 120, 13)
    for a, b in zip(jr, tr):
        for node in [*a.path.nodes, len(jg.nodes) - 1]:
            for pos in (0, 3, a.path.t_start):
                assert graph.node_pos_to_read_pos(tg, b, node, pos) == \
                    jgraph.node_pos_to_read_pos(jg, a, node, pos)


@pytest.mark.parametrize("seed", [2, 5])
def test_random_walk_helpers_equal_jax(graph_file, seed):
    """bases_in_graph, rand_location_fast and rand_path_fwd from the same
    generator state give the JAX's values and leave the same state."""
    jg, tg = _graphs(graph_file)
    total = jgraph.bases_in_graph(jg)
    assert graph.bases_in_graph(tg) == total
    ja, ta = jgr.GoRand(seed), tgr.GoRand(seed)
    for length in (1, 50, 400):
        loc = jgraph.rand_location_fast(jg, total, ja)
        assert graph.rand_location_fast(tg, total, ta) == loc
        jp, jend, jseq = jgraph.rand_path_fwd(jg, *loc, length, ja)
        tp, tend, tseq = graph.rand_path_fwd(tg, *loc, length, ta)
        assert (tp, tend) == (jp, jend)
        np.testing.assert_array_equal(tseq, jseq)
        assert (list(ta._v), ta.tap, ta.feed) == (list(ja._v), ja.tap,
                                                  ja.feed)


# --- multFaVisualizer and multFaVisualizeBeds ---

@pytest.fixture(scope="module")
def aln_file(tmp_path_factory):
    """A three-row multiFa alignment of 420 columns: gaps in every row
    (the reference's in runs), a lower-case run, query rows mostly equal
    to the reference with seeded changes; names of 3, 9 and 5
    characters."""
    rng = np.random.default_rng(3602)
    n = 420
    ref = np.array(list("ACGT"))[rng.integers(0, 4, n)]
    ref[[30, 31, 32, 200, 201, 350]] = "-"
    ref[100:130] = np.char.lower(ref[100:130])
    rows = [ref]
    for _ in range(2):
        q = ref.copy()
        change = rng.random(n) < 0.15
        q[change] = np.array(list("ACGTacgt-"))[rng.integers(0, 9,
                                                               change.sum())]
        rows.append(q)
    path = str(tmp_path_factory.mktemp("vis") / "aln.fa")
    with open(path, "w") as fh:
        for name, r in zip(("ref", "chimpanzee", "gorla"), rows):
            fh.write(f">{name}\n{''.join(r)}\n")
    return path


VIS_CASES = {
    "default": ["10", "200"],
    "line_37": ["0", "150", "-lineLength", "37"],
    "end": ["5", "END", "-lineLength", "60"],
    "end_lower_no_mask": ["5", "end", "-noMask"],
    "one_base": ["120", "121"],
    "no_mask_line_1": ["28", "36", "-noMask", "-lineLength", "1"],
    "start_not_below_end": ["200", "100"],
    "start_equals_end": ["100", "100"],
    "ran_out": ["100000", "END"],
    "ran_off": ["10", "100000"],
}


@pytest.mark.parametrize("case", list(VIS_CASES))
def test_mult_fa_visualizer_equal_jax(aln_file, tmp_path, case):
    """multFaVisualizer through each umbrella: the same file bytes, or the
    same exception (the header is written before the end scan, so a view
    that runs off the chromosome leaves it)."""
    out = _both(tmp_path, lambda d: [
        "multFaVisualizer", aln_file, d + "/view.txt", *VIS_CASES[case]])
    assert out["port"] == out["jax"]
    if case.startswith(("start", "ran")):
        assert out["jax"][0] == "ValueError"
    else:
        assert out["jax"][0] == "ok"
        assert out["jax"][2]["view.txt"].count(b"Position: ") >= 1


def test_mult_fa_visualizer_to_stdout(aln_file, capsys):
    """With ``-`` as the output the view goes to stdout alike."""
    printed = []
    for fn in (jbrowser.multi_fa_visualizer, browser.multi_fa_visualizer):
        fn(aln_file, "-", 3, 90, False, 40, False)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].startswith("Start: 3. refCounter: 3.")


BED_CASES = {
    "names_by_coords": [],
    "names_by_name": ["-outFormatName", "-noMask"],
    "line_25": ["-lineLength", "25"],
}


@pytest.mark.parametrize("case", list(BED_CASES))
def test_mult_fa_visualize_beds_equal_jax(aln_file, tmp_path, case):
    """multFaVisualizeBeds writes the same tree of files, named by
    coordinates or by the name column, under -outDir."""
    bed = tmp_path / "r.bed"
    bed.write_text("ref\t0\t40\tfirst\nref\t25\t180\tsecond\n"
                   "ref\t300\t301\tthird\n")
    out = _both(tmp_path, lambda d: [
        "multFaVisualizeBeds", str(bed), aln_file, *BED_CASES[case],
        "-outDir", d + "/"])
    assert out["port"] == out["jax"]
    assert len(out["jax"][2]) == 3


def test_mult_fa_visualize_beds_empty_region(aln_file, tmp_path):
    """A region whose start is its end raises alike, after the files of
    the regions before it."""
    bed = tmp_path / "r.bed"
    bed.write_text("ref\t5\t50\ta\nref\t60\t60\tb\n")
    out = _both(tmp_path, lambda d: [
        "multFaVisualizeBeds", str(bed), aln_file, "-outDir", d + "/"])
    assert out["port"] == out["jax"]
    assert out["jax"][0] == "ValueError" and len(out["jax"][2]) == 1


# --- faChunkAlign ---

def _chunk_records(seed, n_rec, n_chunks, chunk, lower=False):
    """n_rec records from a seeded base of n_chunks chunks: a share of the
    chunks with a base changed, one or two whole-chunk deletions and a
    random chunk inserted in some."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("acgt" if lower else "ACGT"))
    base = ["".join(letters[rng.integers(0, 4, chunk)])
            for _ in range(n_chunks)]
    out = []
    for r in range(n_rec):
        ch = list(base)
        for i, w in enumerate(ch):
            if rng.random() < 0.3:
                k = int(rng.integers(chunk))
                ch[i] = w[:k] + letters[rng.integers(4)] + w[k + 1:]
        for _ in range(int(rng.integers(1, 3))):
            at = int(rng.integers(len(ch) - 1))
            del ch[at:at + int(rng.integers(1, 3))]
        if r % 2:
            at = int(rng.integers(len(ch) + 1))
            ch[at:at] = ["".join(letters[rng.integers(0, 4, chunk)])]
        out.append((f"seq{r}", "".join(ch)))
    return out


def _write_fa(path, records):
    with open(path, "w") as fh:
        fh.writelines(f">{n}\n{s}\n" for n, s in records)
    return str(path)


CHUNK_CASES = {  # seed, records, chunks, chunk size, flags
    "four_by_10": (1, 4, 12, 10, []),
    "five_by_5_penalties": (2, 5, 15, 5, ["-gapOpen", "100", "-gapExtend",
                                          "10"]),
    "three_by_1": (3, 3, 40, 1, []),
    "two_by_3_lower": (4, 2, 10, 3, []),
    "six_by_4": (5, 6, 9, 4, ["-gapExtend", "5"]),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_fa_chunk_align_equal_jax(tmp_path, case):
    """faChunkAlign through each umbrella writes the same FASTA bytes."""
    seed, n_rec, n_chunks, chunk, flags = CHUNK_CASES[case]
    fa = _write_fa(tmp_path / "in.fa", _chunk_records(
        seed, n_rec, n_chunks, chunk, lower=case.endswith("lower")))
    out = _both(tmp_path, lambda d: [
        "faChunkAlign", *flags, fa, str(chunk), d + "/out.fa"])
    assert out["port"] == out["jax"]
    text = out["jax"][2]["out.fa"].decode()
    assert "-" * chunk in text


def test_fa_chunk_align_divisibility_error(tmp_path):
    """A record whose length is not a multiple of the chunk size raises
    alike."""
    fa = _write_fa(tmp_path / "in.fa", [("a", "ACGTACG"), ("b", "ACGTAC")])
    out = _both(tmp_path, lambda d: ["faChunkAlign", fa, "3", d + "/o.fa"])
    assert out["port"] == out["jax"]
    assert out["jax"][0] == "ValueError"


def test_chunk_sub_matrix_and_verbose_equal_jax(capsys):
    """_chunk_sub_matrix of two groups is the JAX's, and the verbose
    merge lines print alike."""
    recs = _chunk_records(6, 4, 8, 5)
    jr = [JFasta(n, jdna.from_string(s)) for n, s in recs]
    tr = [Fasta(n, dna.from_string(s)) for n, s in recs]
    first = recs[0][1]
    grouped = [first, "-" * 5 + first[5:15] + "-" * 5 + first[20:],
               recs[1][1][:len(recs[1][1]) // 5 * 5]]
    jg = [JFasta(f"g{i}", jdna.from_string(s)) for i, s in enumerate(grouped)]
    tg = [Fasta(f"g{i}", dna.from_string(s)) for i, s in enumerate(grouped)]
    np.testing.assert_array_equal(
        multi._chunk_sub_matrix(tg[:2], tg[2:3], matrices.HUMAN_CHIMP_TWO, 5),
        jmulti._chunk_sub_matrix(jg[:2], jg[2:3], jmatrices.HUMAN_CHIMP_TWO,
                                 5))
    printed = []
    for mod, rs, m in ((jmulti, jr, jmatrices), (multi, tr, matrices)):
        rows = mod.all_seq_affine_chunk(rs, m.HUMAN_CHIMP_TWO, -300, -40, 5,
                                        verbose=True)
        printed.append((capsys.readouterr().out,
                        [(r.name, jdna.to_string(r.seq)) for r in rows]))
    assert printed[0] == printed[1]
    assert printed[0][0].count("merging groups") == 3


# --- faDrawAlnChunks ---

def _png(path):
    with Image.open(path) as im:
        return im.size, np.asarray(im.convert("RGB"))


DRAW_CASES = {
    "many_chunks": (7, 6, 30, 10),
    "chunk_3": (8, 3, 12, 3),
    "few_chunks": (9, 2, 5, 4),
}


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_fa_draw_aln_chunks_equal_jax(tmp_path, case):
    """faDrawAlnChunks of a chunk alignment (the JAX faChunkAlign's
    output) draws the same pixels and writes the same PNG bytes."""
    seed, n_rec, n_chunks, chunk = DRAW_CASES[case]
    fa = _write_fa(tmp_path / "in.fa",
                   _chunk_records(seed, n_rec, n_chunks, chunk))
    aln = str(tmp_path / "aln.fa")
    jmain.main(["faChunkAlign", fa, str(chunk), aln])
    pngs = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        pngs[side] = str(tmp_path / f"{side}.png")
        mod.main(["faDrawAlnChunks", aln, str(chunk), pngs[side]])
    (jsize, jpix), (tsize, tpix) = _png(pngs["jax"]), _png(pngs["port"])
    assert tsize == jsize
    np.testing.assert_array_equal(tpix, jpix)
    with open(pngs["jax"], "rb") as a, open(pngs["port"], "rb") as b:
        assert a.read() == b.read()
    if case == "many_chunks":  # past the 19 palette colours
        assert len({tuple(p) for p in tpix[6::12, 3:jsize[0] - 210:6]
                    .reshape(-1, 3)}) >= 20


@pytest.mark.parametrize("rows", [
    [("a", "ACG---"), ("b", "AC-TTT")],
    [("a", "ACGTA"), ("b", "ACGTA")],
])
def test_fa_draw_aln_chunks_errors_equal_jax(tmp_path, rows):
    """A chunk part gap and part base, and a length not divisible by the
    chunk size, raise alike."""
    fa = _write_fa(tmp_path / "aln.fa", rows)
    out = _both(tmp_path, lambda d: ["faDrawAlnChunks", fa, "3",
                                     d + "/o.png"])
    assert out["port"] == out["jax"]
    assert out["jax"][0] == "ValueError"


# --- chip_smoke's gates ---

def test_sim_views_checks_pass_on_jax_outputs(tmp_path):
    """chip_smoke's sim_views_checks read the files that the JAX tools
    write from sim_views_inputs at a small size (240 simulated reads on
    a 6 kb graph, 10 somatic SNVs; gsw align of the JAX host engine; the
    routes of the port's affine_gap on the CPU), and every gate holds."""
    p = small_tools_inputs(str(tmp_path))
    rows = chip_smoke.fasta_text(p["aln.fa"])
    q_fa = str(tmp_path / "q.fa")
    with open(q_fa, "w") as fh:
        fh.write(">chr1\n" + rows["Query"].replace("-", "") + "\n")
    snps = {"chr1": []}
    with open(p["c.vcf"]) as fh:
        for ln in fh:
            w = ln.split("\t")
            if w[0] == "chr1" and len(w[3]) == len(w[4]) == 1:
                snps["chr1"].append((int(w[1]), w[3], w[4]))
    sv = chip_smoke.sim_views_inputs(str(tmp_path), p["v.gg"], p["t.fa"],
                                     q_fa, p["aln.fa"], snps, reads=240,
                                     snv=10, msa=(4, 30))

    def step(name, *argv):
        argv = list(argv)
        if argv[:2] == ["gsw", "align"]:
            argv = argv[:-2]  # the JAX CLI takes no --device
        jmain.main(argv)

    sv = chip_smoke.sim_views_steps(step, sv, torch.device("cpu"), {})
    x = chip_smoke.sim_views_checks(sv)
    share = x["giraf_simulate"]["true_path_share"]
    assert chip_smoke.sim_views_ok(x, true_share=share), x
    assert share >= 0.95
    assert x["somatic"]["locations"] < x["somatic"]["strand_aware_locations"]
