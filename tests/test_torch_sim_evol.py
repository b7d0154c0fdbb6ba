"""The port's evolution simulators and the accuracy and ILS tools
(gonomics_tpu_torch/simulate.py, io/formats.py, phylo/etree.py,
phylo/reconstruct.py, cli/simulate_evol.py, cli/sim_recon.py,
cli/ils_reconstruct_seq.py) on the CPU against the JAX package.

Every file a tool writes is held to the JAX tool's bytes (FASTA, VCF,
newick, accuracy tables, ``.pfa``), every exit to its type and message;
each library call that takes a generator is held to the JAX's value and
to its generator's state after the call (a ``GoRand``'s ``_v``, ``tap``
and ``feed``; a numpy Generator's bit generator state); the record
readers to the JAX's records field by field. The inputs are built here
from numpy seeds and stay small: a 300-base root, trees of three to
seven leaves.
"""

import dataclasses

import numpy as np
import pytest

from gonomics_tpu import simulate as jsim
from gonomics_tpu.cli import ils_reconstruct_seq as jils
from gonomics_tpu.cli import sim_recon as jsr
from gonomics_tpu.cli import simulate_evol as jevol
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import formats as jfmt
from gonomics_tpu.io import sam as jsamio
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu.phylo import etree as jetree
from gonomics_tpu.phylo import reconstruct as jrecon
from gonomics_tpu_torch import dna
from gonomics_tpu_torch import simulate as tsim
from gonomics_tpu_torch.cli import ils_reconstruct_seq as tils
from gonomics_tpu_torch.cli import sim_recon as tsr
from gonomics_tpu_torch.cli import simulate_evol as tevol
from gonomics_tpu_torch.io import fasta as tfasta
from gonomics_tpu_torch.io import formats as tfmt
from gonomics_tpu_torch.io import sam as tsamio
from gonomics_tpu_torch.numbers import gorand as tgr
from gonomics_tpu_torch.phylo import etree as tetree
from gonomics_tpu_torch.phylo import reconstruct as trecon

# a two-exon gene on the 300-base root: exon 0 is 91 bases, completed by
# the first 2 bases of exon 1 (frame 2); the start codon at 30, the stop
# codon's first base at cds_end - 3 = 266
GENE = "g1\tchr1\t+\t0\t300\t30\t269\t2\t30,150,\t121,269,\t0,2,"
TREE3 = "((a:0.1,b:0.2)ab:0.05,c:0.3)root:0.02;"
TREE_TOPO = "((a,b)ab,(c,(d,e)de)cde)root;"
# the 10-base input of withIndels' pop() cases: seed 1 starts a deletion
# on the last base, seed 2 an insertion (at branch length 0.3, propIndel 1)
POP_SEQ = "ACGTACGTAC"


def _state(rng):
    if isinstance(rng, np.random.Generator):
        return rng.bit_generator.state
    return rng._v, rng.tap, rng.feed


def _rngs(kind, seed):
    if kind == "go":
        return jgr.GoRand(seed), tgr.GoRand(seed)
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _recs(records):
    return [(r.name, np.asarray(r.seq).tobytes()) for r in records]


def _write(path, lines):
    path.write_text("".join(ln + "\n" for ln in lines))
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except BaseException as e:  # SystemExit included
        return "raise", type(e).__name__, str(e)


def _cli(tmp_path, jmain, tmain, argv_of, names):
    """Both tools' outcomes: the bytes of each output named, or the type
    and message of what they raised; argv_of(paths) builds the argv."""
    res = []
    for side, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        outs = [str(d / n) for n in names]
        got = _outcome(main, argv_of(outs))
        if got[0] == "ok":
            got = ("ok", [_read(o) if (d / n).exists() else None
                          for o, n in zip(outs, names)])
        res.append(got)
    return res


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_evol")
    rng = np.random.default_rng(3300)
    root = rng.choice(list("ACGT"), 300)
    root[30:33] = list("ATG")
    root[266:269] = list("GGC")  # not a stop codon: the model picks one
    low = rng.choice(list("acgtACGT"), 80)
    low[[0, 17, 50]] = "N"
    f = {"root.fa": _write(d / "root.fa", [">root", "".join(root)]),
         "low.fa": _write(d / "low.fa", [">myRoot", "".join(low)]),
         "two.fa": _write(d / "two.fa", [">x", "ACGT", ">y", "ACGT"]),
         "pop.fa": _write(d / "pop.fa", [">s", POP_SEQ]),
         "gene.gp": _write(d / "gene.gp", [GENE]),
         "gene10.gp": _write(d / "gene10.gp",
                             ["\t".join(GENE.split("\t")[:10])]),
         "tree3.nh": _write(d / "tree3.nh", [TREE3]),
         "tree5.nh": _write(d / "tree5.nh", [
             "((a:0.05,b:0.1)ab:0.08,(c:0.2,(d:0.02,e:0.3)de:0.1)cde:0.04)"
             "root;"]),
         "m4.txt": _write(d / "m4.txt", [
             "0.7\t0.1\t0.1\t0.1", "0.1\t0.7\t0.1\t0.1",
             "0.1\t0.1\t0.7\t0.1", "0.1\t0.1\t0.1\t0.7"]),
         "m3.txt": _write(d / "m3.txt", [
             "0.7\t0.1\t0.1\t0.1", "0.1\t0.7\t0.1\t0.1",
             "0.1\t0.1\t0.7\t0.1"])}
    seq = rng.choice(list("ACGTacgt"), 300)
    f["wi.fa"] = _write(d / "wi.fa", [">chrW", "".join(seq)])
    f["dir"] = d
    return f


# --- io/formats: PSL, genePred, MAF, GTF ---

PSL_ROWS = [
    "10\t1\t0\t0\t1\t2\t0\t0\t+\tq1\t20\t0\t13\tt1\t100\t5\t16\t2\t"
    "5,6,\t0,7,\t5,10,",
    "7\t0\t2\t1\t0\t0\t1\t3\t-\tq2\t12\t2\t12\tt1\t100\t40\t53\t1\t"
    "10,\t2,\t40,"]


def test_read_psl_skips_headers_and_short_lines(tmp_path):
    """read_psl skips the psLayout header, the column names, the dashes,
    a blank line and a 20-field line; the records and each writer's
    round trip equal the JAX's."""
    path = _write(tmp_path / "a.psl", [
        "psLayout version 3", "", "match\tmis-\trep.", "-" * 30,
        PSL_ROWS[0], "\t".join(PSL_ROWS[1].split("\t")[:20]),
        PSL_ROWS[1]])
    j, t = jfmt.read_psl(path), tfmt.read_psl(path)
    assert [dataclasses.asdict(x) for x in t] == \
        [dataclasses.asdict(x) for x in j]
    assert len(t) == 2
    text = [tfmt.psl_to_string(x) for x in t]
    assert text == [jfmt.psl_to_string(x) for x in j] == PSL_ROWS
    again = _write(tmp_path / "b.psl", text)
    assert [dataclasses.asdict(x) for x in tfmt.read_psl(again)] == \
        [dataclasses.asdict(x) for x in t]


@pytest.mark.parametrize("columns", [10, 11])
def test_read_gene_pred(tmp_path, columns):
    """exon_frames comes only from an 11th column; the writer ends each
    list with ',' (an empty one with ',' alone)."""
    rows = [GENE, "g2\tchr2\t-\t5\t90\t10\t80\t3\t5,30,60,\t20,40,90,\t"
            "1,0,2,"]
    path = _write(tmp_path / "a.gp",
                  ["\t".join(r.split("\t")[:columns]) for r in rows])
    j, t = jfmt.read_gene_pred(path), tfmt.read_gene_pred(path)
    assert [dataclasses.asdict(x) for x in t] == \
        [dataclasses.asdict(x) for x in j]
    assert all(bool(x.exon_frames) == (columns == 11) for x in t)
    text = [tfmt.gene_pred_to_string(x) for x in t]
    assert text == [jfmt.gene_pred_to_string(x) for x in j]
    again = _write(tmp_path / "b.gp", text)
    back = tfmt.read_gene_pred(again)
    assert [tfmt.gene_pred_to_string(x) for x in back] == text
    if columns == 11:
        assert text == rows


def _maf_key(blocks):
    return [(b.score, [(s.src, s.start, s.size, s.strand, s.src_size,
                        s.seq.tobytes()) for s in b.s_lines])
            for b in blocks]


def test_read_maf_and_maf_to_fasta(tmp_path):
    """Blocks, their scores and s lines (i, e and q lines skipped); the
    stitched alignment gaps a species a block lacks."""
    path = _write(tmp_path / "a.maf", [
        "##maf version=1 scoring=x", "# a comment", "",
        "a score=12.5", "s hg38.chr1 10 6 + 1000 ACG-TAC",
        "s mm10.chr2 20 7 - 900 ACGTTAC", "i mm10.chr2 C 0 C 0", "",
        "a", "s hg38.chr1 16 4 + 1000 GGTA", "e panTro.chr1 5 3 + 50 I", "",
        "a score=-3", "s mm10.chr2 30 3 + 900 T-Ta",
        "s panTro.chr1 8 4 + 50 TTTA", "q panTro.chr1 9999"])
    j, t = jfmt.read_maf(path), tfmt.read_maf(path)
    assert _maf_key(t) == _maf_key(j)
    assert [b.score for b in t] == [12.5, 0.0, -3.0]
    order = ["hg38", "mm10", "panTro", "rheMac"]
    jf, tf = jfmt.maf_to_fasta(j, order), tfmt.maf_to_fasta(t, order)
    assert _recs(tf) == _recs(jf)
    assert dna.to_string(tf[1].seq) == "ACGTTAC----T-Ta"
    assert _recs(tfmt.maf_to_fasta([], order)) == \
        _recs(jfmt.maf_to_fasta([], order))


def test_read_gtf(tmp_path):
    """Genes and transcripts in file order; an exon of a transcript not
    yet seen opens it; UTR and codon features open but are not kept; a
    line of fewer than 9 fields is skipped; '.' score and frame."""
    attrs = 'gene_id "G{g}"; transcript_id "T{t}"; gene_name "N{g}";'
    rows = [
        ("chr1", "src", "transcript", 11, 500, ".", "+", ".", 1, 1),
        ("chr1", "src", "exon", 11, 100, "3.5", "+", ".", 1, 1),
        ("chr1", "src", "CDS", 40, 100, ".", "+", "0", 1, 1),
        ("chr1", "src", "5UTR", 11, 39, ".", "+", ".", 1, 1),
        ("chr1", "src", "exon", 300, 500, ".", "+", ".", 1, 1),
        ("chr2", "src", "exon", 7, 70, ".", "-", ".", 2, 3),
        ("chr2", "src", "stop_codon", 7, 9, ".", "-", "0", 2, 4),
        ("chr2", "src", "gene", 1, 900, ".", "-", ".", 2, 3),
        ("chr2", "src", "CDS", 10, 60, "1", "-", "2", 2, 3)]
    lines = ["\t".join(map(str, r[:8]))
             + "\t" + attrs.format(g=r[8], t=r[9]) for r in rows]
    lines.insert(3, "chr1\tsrc\texon\t1\t2")
    path = _write(tmp_path / "a.gtf", lines)
    j, t = jfmt.read_gtf(path), tfmt.read_gtf(path)
    assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.items()}
    assert [len(g.transcripts) for g in t.values()] == [1, 2]
    assert t["G2"].transcripts[0].cds[0].frame == 2


# --- phylo/etree.to_newick_string ---

@pytest.mark.parametrize("text", [
    TREE_TOPO, TREE3, "((a:0.1234567,b:2)ab:0,c:1e-3)r:0.5;"])
def test_to_newick_string(text):
    """Topology-only trees and trees with lengths (%f), left child
    first."""
    j = jetree.to_newick_string(jetree.parse_newick(text))
    t = tetree.to_newick_string(tetree.parse_newick(text))
    assert t == j
    assert t.endswith(";")


# --- genic ---

@pytest.mark.parametrize("kind", ["go", "numpy"])
@pytest.mark.parametrize("deletions", [True, False])
def test_simulate_genic(inputs, kind, deletions):
    """Every node's record and the generator's state after the walk."""
    f = inputs
    out = []
    for etree_mod, sim_mod, rng in zip((jetree, tetree), (jsim, tsim),
                                       _rngs(kind, 7)):
        tree = etree_mod.read_tree(f["tree3.nh"], f["root.fa"])
        sim_mod.simulate_genic(f["root.fa"], tree, f["gene.gp"], deletions,
                               rng)
        out.append((_recs(n.fasta for n in etree_mod.get_tree(tree)),
                    _state(rng)))
    assert out[1] == out[0]
    assert len(out[1][0]) == 5


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("seed", [[], ["--setSeed", "11"]])
def test_genic_cli(inputs, tmp_path, complete, seed):
    """The leaves (every node with --completeSimOutput); --setSeed's
    default -1 on the command line."""
    f = inputs

    def argv(o):
        extra = ["--completeSimOutput", o[1]] if complete else []
        return ["genic", *seed, *extra, "--genePred", f["gene.gp"],
                f["tree3.nh"], f["root.fa"], o[0]]

    res = _cli(tmp_path, jevol.main, tevol.main, argv, ["leaves.fa",
                                                        "all.fa"])
    assert res[1] == res[0]
    assert res[0][0] == "ok"
    assert (res[0][1][1] is not None) == complete


@pytest.mark.parametrize("gp", ["", "gene10.gp"])
def test_genic_errors(inputs, tmp_path, gp):
    """No genePred: FileNotFoundError (reading ''); a 10-column
    genePred: IndexError (no frames), in both packages."""
    f = inputs
    res = []
    for mod in (jevol, tevol):
        res.append(_outcome(mod.genic, f["tree3.nh"], f["root.fa"],
                            str(tmp_path / "o.fa"),
                            gene_pred_file=f[gp] if gp else ""))
    assert res[1] == res[0]
    assert res[0][1] == ("FileNotFoundError" if not gp else "IndexError")


def test_rand_gene_and_bases():
    """rand_gene always ends in TAA (1 // 3 is 0); the base choosers and
    the K80 substitution under both generator kinds."""
    for kind in ("go", "numpy"):
        j, t = _rngs(kind, 5)
        jv = (_recs(jsim.rand_gene(j, "g", 30, 0.4)),
              [jsim.change_base_transition_bias(j, b, 2.5)
               for b in (0, 1, 2, 3, 0, 3)],
              [jsim.change_base(j, b) for b in (0, 1, 2, 3)],
              [jsim.choose_random_base(j, 0.6) for _ in range(8)],
              [jsim._randint_range(j, 3, 90) for _ in range(4)])
        tv = (_recs(tsim.rand_gene(t, "g", 30, 0.4)),
              [tsim.change_base_transition_bias(t, b, 2.5)
               for b in (0, 1, 2, 3, 0, 3)],
              [tsim.change_base(t, b) for b in (0, 1, 2, 3)],
              [tsim.choose_random_base(t, 0.6) for _ in range(8)],
              [tsim._randint_range(t, 3, 90) for _ in range(4)])
        assert tv == jv
        assert _state(t) == _state(j)
        assert tv[0][0][1][-3:] == bytes([dna.T, dna.A, dna.A])
    for mod in (jsim, tsim):
        with pytest.raises(SystemExit, match="divisible by three"):
            mod.rand_gene(np.random.default_rng(0), "g", 31, 0.4)
        with pytest.raises(ValueError, match="unrecognized base"):
            mod.change_base_transition_bias(jgr.GoRand(1), dna.N, 2.0)


# --- withIndels ---

@pytest.mark.parametrize("branch", ["0", "0.1", "1"])
@pytest.mark.parametrize("prop", ["0", "0.5", "1"])
@pytest.mark.parametrize("bias", ["1", "2"])
def test_with_indels(inputs, tmp_path, branch, prop, bias):
    """The alignment and the VCF text over the grid, -lambda as the
    alias of --lambdaValue; the library call's rows and state."""
    f = inputs
    res = _cli(tmp_path, jevol.main, tevol.main, lambda o: [
        "withIndels", "-lambda", "0.5", "--propIndel", prop,
        "--branchLength", branch, "--transitionBias", bias, "--setSeed",
        "21", "--qName", "sim", "--vcfOutFile", o[1], f["wi.fa"], o[0]],
        ["aln.fa", "out.vcf"])
    assert res[1] == res[0]
    assert res[0][0] == "ok"
    lib = []
    for mod, rng in zip((jsim, tsim), _rngs("go", 9)):
        rows = mod.with_indels(rng, f["wi.fa"], float(branch), float(prop),
                               1.0, 0.42, float(bias), "", "q")
        lib.append((_recs(rows), _state(rng)))
    assert lib[1] == lib[0]


@pytest.mark.parametrize("seed", [1, 2])
def test_with_indels_pop_at_the_last_base(inputs, tmp_path, seed):
    """An indel that starts on the last base drops that base from both
    rows (the reference never counts it): the ref row, gaps removed, is
    the input less its last base."""
    f = inputs
    res = _cli(tmp_path, jevol.main, tevol.main, lambda o: [
        "withIndels", "--propIndel", "1", "--branchLength", "0.3",
        "--setSeed", str(seed), "--vcfOutFile", o[1], f["pop.fa"], o[0]],
        ["aln.fa", "out.vcf"])
    assert res[1] == res[0]
    rows = tsim.with_indels(tgr.GoRand(seed), f["pop.fa"], 0.3, 1.0, 1.0,
                            0.42, 1.0, "", "q")
    ref = rows[0].seq
    assert dna.to_string(ref[ref != dna.GAP]) == POP_SEQ[:-1]
    assert len(rows[0].seq) == len(rows[1].seq)


@pytest.mark.parametrize("flags", [
    ["--propIndel", "1.5"], ["--gcContent", "-0.1"],
    ["--transitionBias", "-1"], ["--branchLength", "2"], ["two"]])
def test_with_indels_refusals(inputs, tmp_path, flags):
    f = inputs
    fa = f["two.fa"] if flags == ["two"] else f["wi.fa"]
    flags = [] if flags == ["two"] else flags
    res = _cli(tmp_path, jevol.main, tevol.main,
               lambda o: ["withIndels", *flags, fa, o[0]], ["o.fa"])
    assert res[1] == res[0]
    assert res[0][1] == "SystemExit"


# --- nonCoding ---

NON_CODING = {
    "generated": ["--numNodes", "7", "--lenSeq", "60", "--setSeed", "3"],
    "generated_gc": ["--numNodes", "5", "--lenSeq", "40", "--gcContent",
                     "0.7", "--gammaAlpha", "2", "--gammaBeta", "10",
                     "--unitBranchLength", "0.05"],
    "tree_file": ["--treeFile", "tree5.nh", "--lenSeq", "50",
                  "--unitBranchLength", "0.1", "--setSeed", "4"],
    "fasta_n": ["--treeFile", "tree5.nh", "--fastaFile", "low.fa",
                "--setSeed", "5"],
    "matrix4": ["--treeFile", "tree5.nh", "--lenSeq", "30",
                "--substitutionMatrix", "m4.txt", "--setSeed", "6"],
    "matrix4_alias": ["--numNodes", "3", "--lenSeq", "30",
                      "--substitutionMatrixFile", "m4.txt",
                      "--unitBranchLength", "0.2"],
    "matrix3": ["--substitutionMatrix", "m3.txt"],
    "even_nodes": ["--numNodes", "6"],
    "gamma": ["--gammaBeta", "0"],
    "gc": ["--gcContent", "1.5"],
    "len": ["--lenSeq", "-1"],
    "two_records": ["--treeFile", "tree5.nh", "--fastaFile", "two.fa"]}


@pytest.mark.parametrize("case", list(NON_CODING))
def test_non_coding(inputs, tmp_path, case):
    """Every node's record and the --newickOut text, or the exit; the
    root of a --fastaFile run keeps its record's name, upper-cased, N
    kept."""
    f = inputs
    flags = [f.get(x, x) for x in NON_CODING[case]]
    res = _cli(tmp_path, jevol.main, tevol.main, lambda o: [
        "nonCoding", *flags, "--newickOut", o[1], o[0]], ["out.fa",
                                                          "out.nh"])
    assert res[1] == res[0]
    if case in ("matrix3", "even_nodes", "gamma", "gc", "len",
                "two_records"):
        assert res[0][1] == "SystemExit"
        return
    assert res[0][0] == "ok"
    records = [r.split("\n", 1) for r in res[1][1][0].decode().split(">")[1:]]
    assert res[1][1][1].decode().endswith(";\n")
    if case == "fasta_n":
        assert records[0][0] == "myRoot"
        assert all(seq.startswith("N") and seq == seq.upper()
                   for _, seq in records)


@pytest.mark.parametrize("kind", ["go", "numpy"])
def test_non_coding_library(inputs, kind):
    """non_coding over a read tree: each node's record and the state; an
    N uses up a draw before it is skipped."""
    f = inputs
    out = []
    for etree_mod, sim_mod, fa, rng in zip((jetree, tetree), (jsim, tsim),
                                           (jfasta, tfasta),
                                           _rngs(kind, 13)):
        root = etree_mod.read_newick(f["tree5.nh"])
        seq = np.array([dna.N, 0, 1, 2, 3, dna.N, 3, 2] * 5, np.int8)
        root.fasta = fa.Fasta("root", seq)
        sim_mod.non_coding(root, f["m4.txt"], 0.1, rng)
        out.append((_recs(n.fasta for n in etree_mod.get_tree(root)),
                    etree_mod.to_newick_string(root), _state(rng)))
    assert out[1] == out[0]


@pytest.mark.parametrize("kind", ["go", "numpy"])
@pytest.mark.parametrize("nodes", [1, 7, 13])
def test_sim_etree(kind, nodes):
    out = []
    for etree_mod, sim_mod, rng in zip((jetree, tetree), (jsim, tsim),
                                       _rngs(kind, 17)):
        root = sim_mod.sim_etree(rng, nodes, 1.5, 20.0)
        out.append((etree_mod.to_newick_string(root), _state(rng),
                    len(etree_mod.get_tree(root))))
    assert out[1] == out[0]
    assert out[0][2] == nodes


def test_sim_etree_refuses_even_counts():
    res = [_outcome(mod.sim_etree, tgr.GoRand(1), 4, 1.0, 1.0)
           for mod in (jsim, tsim)]
    assert res[1] == res[0]
    assert res[0][:2] == ("raise", "SystemExit")


def test_parse_substitution_matrix_file(inputs):
    f = inputs
    for arg in ("", f["m4.txt"]):
        assert tsim.parse_substitution_matrix_file(arg) == \
            jsim.parse_substitution_matrix_file(arg)
    res = [_outcome(m.parse_substitution_matrix_file, f["m3.txt"])
           for m in (jsim, tsim)]
    assert res[1] == res[0]
    assert np.array_equal(tsim.BLOSUM, jsim.BLOSUM)
    assert tsim.BLOSUM.dtype == np.float64 and tsim.BLOSUM.shape == (21, 21)


# --- the numpy simulators ---

def test_numpy_simulators(tmp_path):
    """rand_seq, mutate_seq, evolve_tree, _sequencing_errors and
    illumina_paired_sam under one default_rng seed, the reads written by
    each package's write_sam."""
    out = []
    for side, (sim_mod, etree_mod, samio) in (
            ("jax", (jsim, jetree, jsamio)),
            ("port", (tsim, tetree, tsamio))):
        rng = np.random.default_rng(3301)
        seq = sim_mod.rand_seq(rng, 2000, 0.45)
        mut = sim_mod.mutate_seq(rng, seq, 0.2)
        err = sim_mod._sequencing_errors(rng, seq[:100], 0.1)
        same = sim_mod._sequencing_errors(rng, seq[:100], 0.0)
        root = etree_mod.parse_newick(TREE3)
        sim_mod.evolve_tree(root, rng, seq[:200])
        reads = sim_mod.illumina_paired_sam("chr1", seq, 25, 50, 120, 30.0,
                                            0.02, rng)
        header = samio.Header(text=["@HD\tVN:1.6", "@SQ\tSN:chr1\tLN:2000"])
        path = str(tmp_path / f"{side}.sam")
        samio.write_sam(path, header, reads)
        refused = _outcome(sim_mod.illumina_paired_sam, "c", seq, 1, 50, 40,
                           1.0, 0.0, rng)
        out.append((seq.tobytes(), mut.tobytes(), err.tobytes(),
                    same.tobytes(),
                    _recs(n.fasta for n in etree_mod.get_tree(root)),
                    _read(path), refused, _state(rng)))
    assert out[1] == out[0]
    assert out[0][6][1] == "ValueError"
    assert out[0][5].count(b"\n") == 52


# --- simRecon ---

@pytest.mark.parametrize("base_acc", [False, True])
@pytest.mark.parametrize("tree", ["tree3.nh", "tree5.nh"])
def test_sim_recon(inputs, tmp_path, base_acc, tree):
    """The simulated, leaf and reconstructed FASTA and the accuracy
    table(s)."""
    f = inputs
    names = ["sim.fa", "leaf.fa", "recon.fa", "acc.txt", "base.txt"]

    def argv(o):
        extra = ["--baseAccFile", o[4]] if base_acc else []
        return [*extra, "--setSeed", "3", f["root.fa"], f[tree],
                f["gene.gp"], *o[:4]]

    res = _cli(tmp_path, jsr.main, tsr.main, argv, names)
    assert res[1] == res[0]
    assert res[0][0] == "ok"
    acc = res[1][1][3].decode().splitlines()
    assert acc[-1].startswith("All Reconstructed Nodes\t")
    assert (res[1][1][4] is not None) == base_acc


def test_recon_accuracy_missing_name(inputs, tmp_path):
    """A recon without one simulated record: each accuracy function's
    SystemExit message, in both packages; no genePred: the exon
    division by zero, in both."""
    f = inputs
    d = tmp_path
    tsr.sim_recon(f["root.fa"], f["tree3.nh"], f["gene.gp"],
                  str(d / "sim.fa"), str(d / "leaf.fa"),
                  str(d / "recon.fa"), str(d / "acc.txt"))
    text = (d / "recon.fa").read_text().split(">")
    (d / "short.fa").write_text(">" + ">".join(
        r for r in text[1:] if not r.startswith("ab\n")))
    for args in (
            (str(d / "sim.fa"), str(d / "short.fa"), f["gene.gp"]),):
        res = [_outcome(m.recon_accuracy_by_base, *args)
               for m in (jrecon, trecon)]
        assert res[1] == res[0]
        assert res[0][1] == "SystemExit"
    for gp, err in ((f["gene.gp"], "SystemExit"), ("", "ZeroDivisionError")):
        recon = str(d / ("short.fa" if gp else "recon.fa"))
        res = [_outcome(m.recon_accuracy, str(d / "sim.fa"), recon,
                        str(d / "leaf.fa"), gp, False)
               for m in (jrecon, trecon)]
        assert res[1] == res[0]
        assert res[0][1] == err


def test_recon_accuracy_values(inputs, tmp_path):
    """The accuracy maps as floats, bit for bit."""
    f = inputs
    d = tmp_path
    tsr.sim_recon(f["root.fa"], f["tree5.nh"], f["gene.gp"],
                  str(d / "sim.fa"), str(d / "leaf.fa"),
                  str(d / "recon.fa"), str(d / "acc.txt"), set_seed=8)
    args = (str(d / "sim.fa"), str(d / "recon.fa"), str(d / "leaf.fa"),
            f["gene.gp"], True)
    j, t = jrecon.recon_accuracy(*args), trecon.recon_accuracy(*args)
    assert list(t[0]) == list(j[0])
    assert np.array_equal(np.array(list(t[0].values())).view(np.int64),
                          np.array(list(j[0].values())).view(np.int64))
    assert {k: np.array(v).view(np.int64).tolist() for k, v in t[1].items()} \
        == {k: np.array(v).view(np.int64).tolist() for k, v in j[1].items()}


# --- ilsReconstructSeq ---

def _ils_inputs(d, n_recons, length, weights_sum_to_one=True, seed=3302):
    """n_recons .pfa files of one record each (rows on a grid of 1/16,
    so float16 keeps them), a wig of weights each, the list files and
    the sizes; the weights at each position sum to 1 unless told not
    to."""
    from gonomics_tpu_torch.io import pfasta

    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n_recons), length)
    if not weights_sum_to_one:
        w[length // 3] *= 1.25
    pfas, wigs = [], []
    for k in range(n_recons):
        counts = rng.multinomial(16, np.ones(4) / 4, length)
        name = f"top{k}"
        pfa = str(d / f"{name}.pfa")
        pfasta.write(pfa, [pfasta.PFasta(name,
                                         (counts / 16).astype(np.float32))])
        wig = str(d / f"{name}.wig")
        _write(d / f"{name}.wig", [f"fixedStep chrom={name} start=1 step=1"]
               + [repr(float(x)) for x in w[:, k]])
        pfas.append(pfa)
        wigs.append(wig)
    sizes = _write(d / "chrom.sizes",
                   [f"top{k}\t{length}" for k in range(n_recons)])
    return (_write(d / "post.list", wigs), _write(d / "recons.list", pfas),
            sizes)


@pytest.mark.parametrize("n_recons", [2, 3])
def test_ils_reconstruct_seq(tmp_path, n_recons):
    """The .pfa bytes of the weighted sum."""
    post, recons, sizes = _ils_inputs(tmp_path, n_recons, 257)
    res = _cli(tmp_path, jils.main, tils.main,
               lambda o: [post, recons, sizes, o[0]], ["out.pfa"])
    assert res[1] == res[0]
    assert res[0][0] == "ok" and len(res[0][1][0]) > 257 * 8


@pytest.mark.parametrize("n_recons", [2, 3])
def test_ils_reconstruct_seq_float32_sum(tmp_path, n_recons):
    """The weighted sum before the .pfa's float16: float32, bit for bit,
    each weight rounded to float32 before it multiplies."""
    from gonomics_tpu.io import pfasta as jpfasta
    from gonomics_tpu.io import wig as jwig
    from gonomics_tpu_torch.io import pfasta as tpfasta
    from gonomics_tpu_torch.io import wig as twig

    post, recons, sizes = _ils_inputs(tmp_path, n_recons, 2000, seed=3303)
    res = []
    for pf, wg, mod in ((jpfasta, jwig, jrecon), (tpfasta, twig, trecon)):
        rec = [pf.read(p)[0] for p in open(recons).read().split()]
        pp = [wg.read(w, sizes, 0) for w in open(post).read().split()]
        out = mod.ils_reconstruct_seq(pp, rec, 0.001)
        res.append((out.name, out.seq.dtype.str, out.seq.tobytes()))
    assert res[1] == res[0]
    assert res[0][1] == "<f4"


def test_ils_reconstruct_seq_not_one(tmp_path):
    """Weights that miss 1 at a position: the message and its index."""
    post, recons, sizes = _ils_inputs(tmp_path, 3, 90, False)
    res = _cli(tmp_path, jils.main, tils.main,
               lambda o: ["--precision", "0.01", post, recons, sizes, o[0]],
               ["out.pfa"])
    assert res[1] == res[0]
    assert res[0][1] == "SystemExit" and res[0][2].endswith(" at 30")


@pytest.mark.parametrize("case", ["count", "wig_length", "seq_length"])
def test_ils_reconstruct_seq_mismatch(tmp_path, case):
    """Each length check's message, in both packages."""
    from gonomics_tpu.io import pfasta as jpfasta
    from gonomics_tpu.io import wig as jwig
    from gonomics_tpu_torch.io import pfasta as tpfasta
    from gonomics_tpu_torch.io import wig as twig

    post, recons, sizes = _ils_inputs(tmp_path, 2, 40)
    wigs = open(post).read().split()
    pfas = open(recons).read().split()
    if case == "wig_length":
        _write(tmp_path / "chrom.sizes", ["top0\t40", "top1\t41"])
    res = []
    for pf, wg, mod in ((jpfasta, jwig, jrecon), (tpfasta, twig, trecon)):
        rec = [pf.read(p)[0] for p in pfas]
        pp = [wg.read(w, sizes, 0) for w in wigs]
        if case == "count":
            pp = pp[:1]
        if case == "seq_length":
            rec[1].seq = rec[1].seq[:-1]
        res.append(_outcome(mod.ils_reconstruct_seq, pp, rec, 0.001))
    assert res[1] == res[0]
    assert res[0][1] == "SystemExit"
