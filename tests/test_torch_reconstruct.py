"""The port's ``reconstructSeq``, ``primateRecon`` and ``mouseRecon``
(gonomics_tpu_torch/cli/) on the CPU against the JAX tools: the bytes of
every output file (the ``.pfa`` of ``-pDnaNode`` included), and the
message of every exit. The inputs are built here: the "all possible"
column sets of tests/test_deprecated_recon.py's ``_combos`` (every
combination of A, C, G, T, N and gap over the free rows, in the
reference tests' nested-loop order), which are full of exact likelihood
ties, seeded random alignments with gap runs, N and lower case, and
newick trees that the tests write (4 and 6 leaves, with branch lengths
and topology only). Also the library copies under them, equal to the
JAX's in float64: ``reconstruct_tree``'s marginals and pDna
probabilities, ``fractional_symmetric_matrix_exponentiation``,
``parse_substitution_matrix``, the newick reader and ``io/pfasta.py``'s
bytes.
"""

import os

import numpy as np
import pytest

from gonomics_tpu.cli import mouse_recon as jmouse_recon
from gonomics_tpu.cli import primate_recon as jprimate_recon
from gonomics_tpu.cli import reconstruct_seq as jreconstruct_seq
from gonomics_tpu.io import pfasta as jpfasta
from gonomics_tpu.numbers import matrix as jmatrix
from gonomics_tpu.phylo import etree as jetree
from gonomics_tpu.phylo import reconstruct as jreconstruct
from gonomics_tpu_torch import dna
from gonomics_tpu_torch.cli import mouse_recon, primate_recon, reconstruct_seq
from gonomics_tpu_torch.io import fasta, pfasta
from gonomics_tpu_torch.numbers import matrix
from gonomics_tpu_torch.phylo import etree, reconstruct

from test_deprecated_recon import POSSIBLE, _combos

TOOLS = {"reconstructSeq": (jreconstruct_seq.main, reconstruct_seq.main),
         "primateRecon": (jprimate_recon.main, primate_recon.main),
         "mouseRecon": (jmouse_recon.main, mouse_recon.main)}

TREES = {
    "four": "((A:0.1,B:0.2)n1:0.05,(C:0.15,D:0.3)n2:0.1)root;",
    "four_topology": "((A,B)n1,(C,D)n2)root;",
    "six": "(((A:0.1,B:0.05)ab:0.1,C:0.2)abc:0.05,"
           "((D:0.12,E:0.3)de:0.07,F:0.4)def:0.1)root;",
}
LEAVES = {"four": "ABCD", "four_topology": "ABCD", "six": "ABCDEF"}
PRIMATES = ("(((hg38:0.0065,(panTro6:0.0027,panPan2:0.0027)pan:0.004)"
            "hca:0.0012,gorGor5:0.0089)hga:0.008,ponAbe3:0.018)root;")
PRIMATES_2H = ("((((hg38:0.001,hg38alt:0.0015)hs:0.006,(panTro6:0.0027,"
               "panPan2:0.0027)pan:0.004)hca:0.0012,gorGor5:0.0089)hga:0.008,"
               "ponAbe3:0.018)root;")
GENERIC = {"hg38": "human", "panTro6": "chimp", "panPan2": "bonobo",
           "gorGor5": "gorilla", "ponAbe3": "orangutan"}
RODENTS = ("(((mm10:0.02,rn7:0.03)mra:0.05,criGriChoV2:0.06)mrh:0.02,"
           "speTri2:0.1)root;")


def _both(tmp_path, tool: str, argv) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits and the files they wrote
    equal; returns the port's {file name: bytes}, or its exit: the
    SystemExit's message, or the type and message of any other
    exception."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        try:
            main(argv(str(d)))
            exit_msg = None
        except SystemExit as e:
            exit_msg = str(e)
        except Exception as e:  # the JAX tools' ValueError, KeyError
            exit_msg = f"{type(e).__name__}: {e}"
        files = {}
        for n in sorted(os.listdir(d)):
            with open(d / n, "rb") as f:
                files[n] = f.read()
        seen[side] = (exit_msg, files)
    assert seen["port"] == seen["jax"]
    exit_msg, files = seen["port"]
    return exit_msg if exit_msg is not None else files


def _write(path, text: str) -> str:
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _write_fa(path, names, cols) -> str:
    fasta.write(str(path), [fasta.Fasta(n, np.asarray(c, np.int8))
                            for n, c in zip(names, cols)])
    return str(path)


def _random_rows(rng, n_rows: int, n: int) -> list:
    """n_rows related rows of n columns: substitutions, gap runs, N and
    a few lower-case bases."""
    anc = rng.integers(0, 4, n).astype(np.int8)
    rows = []
    for _ in range(n_rows):
        r = anc.copy()
        sub = rng.random(n) < 0.12
        r[sub] = rng.integers(0, 4, int(sub.sum()))
        for _ in range(n // 40):
            a = int(rng.integers(0, n))
            r[a:a + int(rng.integers(1, 6))] = dna.GAP
        r[rng.random(n) < 0.02] = dna.N
        low = rng.random(n) < 0.01
        r[low] = dna.to_lower(r[low])
        rows.append(r)
    return rows


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recon")
    rng = np.random.default_rng(2305)
    f = {}
    for name, text in TREES.items():
        f[name] = _write(tmp / f"{name}.nh", text)
    # the "all possible" sets: 6^4 columns over four free leaves, and
    # one fixed A leaf and 6^5 columns over five; an extra record after
    # the first for -keepAllSeq
    four = _combos([], 4)
    f["four_all"] = _write_fa(tmp / "four_all.fa", ["A", "extra1", "B", "C",
                                                     "D", "extra2"],
                              [four[0], four[1], four[1], four[2], four[3],
                               four[0]])
    six = _combos([dna.A], 5)
    f["six_all"] = _write_fa(tmp / "six_all.fa", list("ABCDEF"), six)
    # random alignments, with records not in the tree first and last
    for name, k in (("four", 4), ("six", 6)):
        rows = _random_rows(rng, k + 2, 500)
        f[f"{name}_random"] = _write_fa(
            tmp / f"{name}_random.fa",
            ["out0"] + list(LEAVES[name]) + ["out1"], rows)
    f["matrix"] = _write(tmp / "sub.txt", "0.85\t0.05\t0.06\t0.04\n"
                         "0.05\t0.88\t0.03\t0.04\n0.06\t0.03\t0.82\t0.09\n"
                         "0.04\t0.04\t0.09\t0.83\n")
    f["matrix3"] = _write(tmp / "sub3.txt", "0.9\t0.1\t0\t0\n" * 3)
    f["matrix5"] = _write(tmp / "sub5.txt", "0.9\t0.1\t0\n" * 4)
    # primates: human cycles A, N, gap over 6^4 columns (the reference
    # tests' oneHuman set); two humans A and C; the generic names
    cols = _combos([], 5)
    block = len(POSSIBLE) ** 4
    human = np.concatenate([np.full(block, b, np.int8)
                            for b in (dna.A, dna.N, dna.GAP)])
    rest = [c[:3 * block] for c in cols[1:]]
    five = ["hg38", "panTro6", "panPan2", "gorGor5", "ponAbe3"]
    f["one_human"] = _write_fa(tmp / "one_human.fa", five, [human] + rest)
    f["one_human_generic"] = _write_fa(tmp / "one_human_generic.fa",
                                       [GENERIC[n] for n in five],
                                       [human] + rest)
    six_names = ["hg38", "hg38alt", "panTro6", "panPan2", "gorGor5",
                 "ponAbe3"]
    two = _combos([dna.A, dna.C], 4)
    f["two_humans"] = _write_fa(tmp / "two_humans.fa", six_names, two)
    f["two_humans_generic"] = _write_fa(
        tmp / "two_humans_generic.fa",
        [GENERIC.get(n, n) for n in six_names], two)
    f["primate_random"] = _write_fa(tmp / "primate_random.fa", five,
                                    _random_rows(rng, 5, 400))
    f["primates"] = _write(tmp / "primates.nh", PRIMATES)
    f["primates_2h"] = _write(tmp / "primates_2h.nh", PRIMATES_2H)
    f["primates_no_hca"] = _write(tmp / "primates_no_hca.nh",
                                  PRIMATES.replace("hca", "anc"))
    f["primates_no_hga"] = _write(tmp / "primates_no_hga.nh",
                                  PRIMATES.replace("hga", "anc"))
    f["primates_alt_first"] = _write(
        tmp / "primates_alt_first.nh",
        PRIMATES_2H.replace("hg38:0.001,hg38alt:0.0015",
                            "hg38alt:0.0015,hg38:0.001"))
    generic, generic_2h = PRIMATES, PRIMATES_2H
    for a, b in GENERIC.items():
        generic = generic.replace(a + ":", b + ":")
        generic_2h = generic_2h.replace(a + ":", b + ":")
    f["primates_generic"] = _write(tmp / "primates_generic.nh", generic)
    f["primates_2h_generic"] = _write(tmp / "primates_2h_generic.nh",
                                      generic_2h)
    f["four_rows"] = _write_fa(tmp / "four_rows.fa", five[:4], rest[:4])
    f["uneven"] = _write_fa(tmp / "uneven.fa", five,
                            [human] + rest[:3] + [rest[3][:-1]])
    # rodents: mouse fixed at A over 6^3 columns, and a random set
    rodents = ["mm10", "rn7", "criGriChoV2", "speTri2"]
    f["rodents_all"] = _write_fa(tmp / "rodents_all.fa", rodents,
                                 _combos([dna.A], 3))
    f["rodents_random"] = _write_fa(tmp / "rodents_random.fa", rodents,
                                    _random_rows(rng, 4, 600))
    f["rodents"] = _write(tmp / "rodents.nh", RODENTS)
    f["rodents_no_mra"] = _write(tmp / "rodents_no_mra.nh",
                                 RODENTS.replace("mra", "anc"))
    return f


# --- reconstructSeq -------------------------------------------------------

RECON_FLAGS = {
    "plain": [],
    "bias_leaf": ["-biasLeafName", "A", "-nonBiasProbThreshold", "0.8"],
    "bias_node": ["-biasLeafName", "A", "-biasNodeName", "root",
                  "-nonBiasProbThreshold", "0.5"],
    "bias_n": ["-biasLeafName", "B", "-nonBiasProbThreshold", "0.9",
               "-biasN"],
    "highest": ["-highestProbThreshold", "0.7"],
    "keep_all": ["-keepAllSeq"],
    "sub_default": ["-subMatrix", "-unitBranchLength", "0.1"],
    "sub_file": ["-subMatrix", "-substitutionMatrixFile", "{matrix}",
                 "-unitBranchLength", "0.05"],
    "pdna": ["-pDnaNode", "{node}", "-pDnaOutFile", "{d}/node.pfa"],
    "all": ["-biasLeafName", "C", "-nonBiasProbThreshold", "0.6",
            "-highestProbThreshold", "0.4", "-subMatrix",
            "-unitBranchLength", "0.2", "-pDnaNode", "root",
            "-pDnaOutFile", "{d}/root.pfa", "-keepAllSeq"],
}


@pytest.mark.parametrize("flags", list(RECON_FLAGS))
@pytest.mark.parametrize("tree,data", [("four", "all"), ("six", "all"),
                                       ("four", "random"), ("six", "random"),
                                       ("four_topology", "random")])
def test_reconstruct_seq(inputs, tmp_path, tree, data, flags):
    """Every flag on a 4- and a 6-leaf tree, on the "all possible"
    columns and on a random alignment: the JAX tool's FASTA and .pfa
    bytes."""
    aln = inputs[f"{tree.split('_')[0]}_{data}"]
    node = "n1" if tree.startswith("four") else "abc"

    def argv(d):
        return [inputs[tree], aln, d + "/out.fa"] + [
            a.format(d=d, matrix=inputs["matrix"], node=node)
            for a in RECON_FLAGS[flags]]

    got = _both(tmp_path, "reconstructSeq", argv)
    records = fasta.read(str(tmp_path / "port" / "out.fa"))
    n_leaves = len(LEAVES[tree])
    names = [r.name for r in records]
    leaf_names = list(LEAVES[tree])
    if flags in ("keep_all", "all"):
        # the extra records: the first in front of all, the others after
        with open(aln) as fh:
            extra = [ln[1:].strip() for ln in fh if ln.startswith(">")
                     and ln[1:].strip() not in leaf_names]
        first = int(extra[:1] == ["out0"])
        assert names[:first] == extra[:first]
        assert names[len(names) - len(extra) + first:] == extra[first:]
        names = names[first:len(names) - len(extra) + first]
    assert names[:n_leaves] == leaf_names
    assert len(names) == 2 * n_leaves - 1
    if "pdna" in flags or flags == "all":
        pfa = [n for n in got if n.endswith(".pfa")]
        assert len(pfa) == 1
        recs = pfasta.read(str(tmp_path / "port" / pfa[0]))
        assert len(recs) == 1 and len(recs[0].seq) > 0


@pytest.mark.parametrize("case", ["nonbias_range", "nonbias_no_leaf",
                                  "highest_range", "leaf_not_found",
                                  "leaf_is_root", "unit_zero", "matrix3",
                                  "matrix5", "missing_leaf"])
def test_reconstruct_seq_exits(inputs, tmp_path, case):
    args = {"nonbias_range": ["-nonBiasProbThreshold", "1.5"],
            "nonbias_no_leaf": ["-nonBiasProbThreshold", "0.5"],
            "highest_range": ["-highestProbThreshold", "-0.1"],
            "leaf_not_found": ["-biasLeafName", "Z"],
            "leaf_is_root": ["-biasLeafName", "root"],
            "unit_zero": ["-subMatrix", "-unitBranchLength", "0"],
            "matrix3": ["-subMatrix", "-substitutionMatrixFile",
                        inputs["matrix3"], "-unitBranchLength", "0.1"],
            "matrix5": ["-subMatrix", "-substitutionMatrixFile",
                        inputs["matrix5"], "-unitBranchLength", "0.1"],
            "missing_leaf": []}[case]
    aln = inputs["four_all"]
    if case == "missing_leaf":  # leaf A has no record
        aln = _write_fa(tmp_path / "bcd.fa", list("BCD"),
                        _combos([], 3))
    got = _both(tmp_path, "reconstructSeq",
                lambda d: [inputs["four"], aln, d + "/out.fa", *args])
    assert isinstance(got, str) and got


# --- primateRecon ---------------------------------------------------------

@pytest.mark.parametrize("data", ["one_human", "primate_random"])
@pytest.mark.parametrize("messy", [False, True])
def test_primate_recon_parsimony(inputs, tmp_path, data, messy):
    """The parsimony voter, with and without -messyToN."""
    args = ["-messyToN"] if messy else []
    got = _both(tmp_path, "primateRecon",
                lambda d: args + [inputs[data], d + "/out.fa"])
    assert got["out.fa"].count(b">") == 6


MLE_MODES = {
    "unbiased": (["-mleHcaUnbiased"], "two_humans", "primates_2h"),
    "human": (["-mleHcaHumanBiased"], "one_human", "primates"),
    "chimp": (["-mleHcaChimpBiased"], "one_human", "primates"),
    "gorilla": (["-mleHgaGorillaBiased"], "one_human", "primates"),
}


@pytest.mark.parametrize("thresholds", ["zero", "set"])
@pytest.mark.parametrize("generic", [False, True])
@pytest.mark.parametrize("mode", list(MLE_MODES))
def test_primate_recon_mle(inputs, tmp_path, mode, generic, thresholds):
    """The four MLE modes on the "all possible" columns, with and
    without -useGenericNames, with thresholds zero and set."""
    flags, data, tree = MLE_MODES[mode]
    if generic:
        flags = flags + ["-useGenericNames"]
        data, tree = data + "_generic", tree + "_generic"
    if thresholds == "set":
        flags = flags + (["-probThreshold", "0.9"] if mode == "unbiased"
                         else ["-probThreshold", "0.3",
                               "-nonBiasProbThreshold", "0.8"])
    got = _both(tmp_path, "primateRecon",
                lambda d: flags + ["-mle", inputs[tree], inputs[data],
                                   d + "/out.fa"])
    records = fasta.read(str(tmp_path / "port" / "out.fa"))
    assert records[-1].name == ("hga" if mode == "gorilla" else "hca")
    assert len(records) == (7 if mode == "unbiased" else 6)


@pytest.mark.parametrize("case", [
    "human_and_chimp", "messy_mle", "no_tree", "biased_and_unbiased",
    "threshold_no_mle", "nonbias_unbiased", "hca_and_hga", "four_records",
    "uneven", "no_species", "no_hca", "no_hga", "unbiased_no_alt",
    "leftmost_no_record", "leaf_no_record"])
def test_primate_recon_exits(inputs, tmp_path, case):
    """Each exit for a conflicting flag (primate_recon.py:241-258), the
    parsimony voter's record checks, a tree without the species, without
    hca or hga, the unbiased mode without hg38alt, and a tree leaf
    without a record (the leftmost leaf, which sets the length, and
    another)."""
    tree, one = inputs["primates"], inputs["one_human"]
    args = {
        "human_and_chimp": ["-mleHcaHumanBiased", "-mleHcaChimpBiased",
                            "-mle", tree, one],
        "messy_mle": ["-messyToN", "-mleHcaHumanBiased", "-mle", tree, one],
        "no_tree": ["-mleHcaUnbiased", one],
        "biased_and_unbiased": ["-mleHcaUnbiased", "-mleHcaHumanBiased",
                                "-mle", tree, one],
        "threshold_no_mle": ["-probThreshold", "0.5", one],
        "nonbias_unbiased": ["-mleHcaUnbiased", "-nonBiasProbThreshold",
                             "0.5", "-mle", tree, one],
        "hca_and_hga": ["-mleHcaHumanBiased", "-mleHgaGorillaBiased",
                        "-mle", tree, one],
        "four_records": [inputs["four_rows"]],
        "uneven": [inputs["uneven"]],
        "no_species": ["-mleHcaHumanBiased", "-mle", inputs["six"],
                       inputs["six_all"]],
        "no_hca": ["-mleHcaChimpBiased", "-mle", inputs["primates_no_hca"],
                   one],
        "no_hga": ["-mleHgaGorillaBiased", "-mle", inputs["primates_no_hga"],
                   one],
        "leftmost_no_record": ["-mleHcaHumanBiased", "-mle",
                               inputs["primates_alt_first"], one],
        "unbiased_no_alt": ["-mleHcaUnbiased", "-mle", tree, one],
        "leaf_no_record": ["-mleHcaHumanBiased", "-mle",
                           inputs["primates_2h"], one],
    }[case]
    got = _both(tmp_path, "primateRecon",
                lambda d: args + [d + "/out.fa"])
    assert isinstance(got, str) and got


# --- mouseRecon -----------------------------------------------------------

@pytest.mark.parametrize("data", ["rodents_all", "rodents_random"])
@pytest.mark.parametrize("prob,nonbias", [("0", "0.8"), ("0", "0"),
                                          ("0.4", "0.95")])
def test_mouse_recon(inputs, tmp_path, data, prob, nonbias):
    """The mouse-biased call at "mra" at several thresholds."""
    got = _both(tmp_path, "mouseRecon",
                lambda d: ["-mleTree", inputs["rodents"], "-probThreshold",
                           prob, "-nonBiasProbThreshold", nonbias,
                           inputs[data], d + "/out.fa"])
    assert [r.name for r in fasta.read(str(tmp_path / "port" / "out.fa"))] \
        == ["mm10", "rn7", "criGriChoV2", "speTri2", "mra"]
    assert got["out.fa"]


@pytest.mark.parametrize("tree", ["rodents_no_mra", "none"])
def test_mouse_recon_exits(inputs, tmp_path, tree):
    path = inputs.get(tree, "")
    got = _both(tmp_path, "mouseRecon",
                lambda d: ["-mleTree", path, inputs["rodents_all"],
                           d + "/out.fa"])
    assert isinstance(got, str) and got


# --- the library copies ---------------------------------------------------

def _trees(inputs, tree: str, aln: str, sub: bool):
    out = []
    for mod in (jetree, etree):
        root = mod.read_tree(inputs[tree], aln)
        if sub:
            mod.populate_substitution_matrices(
                root, mod.parse_substitution_matrix(inputs["matrix"]), 0.1)
        out.append(root)
    return out


@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("tree,data", [("four", "all"), ("six", "all"),
                                       ("six", "random")])
def test_marginals_equal_exactly(inputs, tree, data, sub):
    """inside and fix_fc at every internal node, and reconstruct_tree's
    calls and pDna probabilities, equal the JAX's in float64 bit for
    bit."""
    aln = inputs[f"{tree}_{data}"]
    jroot, root = _trees(inputs, tree, aln, sub)
    P = len(etree.get_leaves(root)[0].fasta.seq)
    jstore, store = {}, {}
    jreconstruct.inside(jroot, P, sub, jstore)
    reconstruct.inside(root, P, sub, store)
    for jn, n in zip(jetree.get_tree(jroot), etree.get_tree(root)):
        assert jn.name == n.name
        assert np.array_equal(store[id(n)], jstore[id(jn)])
        if n.left is not None:
            want = jreconstruct.fix_fc(jroot, jn, sub, jstore)
            got = reconstruct.fix_fc(root, n, sub, store)
            assert got.dtype == np.float64 and np.array_equal(got, want)
    kw = dict(bias_leaf_name="B", non_bias_threshold=0.7,
              highest_threshold=0.3, sub_matrix=sub)
    for node in etree.get_branch(root):
        jrec, _ = jreconstruct.reconstruct_tree(jroot, pdna_node=node.name,
                                                **kw)
        rec = reconstruct.reconstruct_tree(root, pdna_node=node.name, **kw)
        assert rec.seq.dtype == np.float32 and len(rec.seq) > 0
        assert np.array_equal(rec.seq, jrec.seq) and rec.name == jrec.name
        for jn, n in zip(jetree.get_branch(jroot), etree.get_branch(root)):
            assert np.array_equal(n.fasta.seq, jn.fasta.seq)


def test_fractional_matrix_powers_equal_exactly(inputs):
    """fractional_symmetric_matrix_exponentiation at several powers, and
    dense_log_symmetric, equal the JAX's bit for bit; a matrix that is
    not symmetric raises the JAX's ValueError."""
    rng = np.random.default_rng(2306)
    a = rng.random((4, 4))
    sym = a @ a.T + 4 * np.eye(4)
    mats = [np.asarray(etree.DEFAULT_SUBSTITUTION_MATRIX),
            np.asarray(etree.parse_substitution_matrix(inputs["matrix"])),
            sym]
    for m in mats:
        assert np.array_equal(matrix.dense_log_symmetric(m),
                              jmatrix.dense_log_symmetric(m))
        for p in (0.05, 0.1, 0.5, 1.0, 2.5, 7.3, -1.0, 0.0):
            got = matrix.fractional_symmetric_matrix_exponentiation(m, p)
            want = jmatrix.fractional_symmetric_matrix_exponentiation(m, p)
            assert got.dtype == np.float64 and np.array_equal(got, want)
        assert matrix.is_symmetric(m) == jmatrix.is_symmetric(m)
    asym = np.arange(16.0).reshape(4, 4)
    assert not matrix.is_symmetric(asym)
    for mod in (matrix, jmatrix):
        with pytest.raises(ValueError, match="only symmetric input"):
            mod.dense_log_symmetric(asym)


def test_parse_substitution_matrix(inputs):
    """The default (a fresh copy each call), a written matrix, and the
    ValueErrors of a matrix of 3 lines and of 3 fields."""
    got = etree.parse_substitution_matrix("")
    assert got == jetree.parse_substitution_matrix("")
    got[0][0] = 0.0
    assert etree.DEFAULT_SUBSTITUTION_MATRIX[0][0] == 0.91
    assert etree.parse_substitution_matrix(inputs["matrix"]) == \
        jetree.parse_substitution_matrix(inputs["matrix"])
    for bad in ("matrix3", "matrix5"):
        msgs = []
        for mod in (jetree, etree):
            with pytest.raises(ValueError) as e:
                mod.parse_substitution_matrix(inputs[bad])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _shape(node):
    if node is None:
        return None
    return (node.name, node.branch_length, node.only_topology,
            _shape(node.left), _shape(node.right))


@pytest.mark.parametrize("text", list(TREES.values()) + [
    PRIMATES, RODENTS, "junk before ((a:1,b:2):3,c:0.5); after",
    "((a:1e-3,b)x,(c,(d:2,e:3)y:4)z);"])
def test_newick_reader(text):
    """The parsed tree (names, branch lengths, topology flags) and the
    orders of get_tree, get_branch and get_leaves equal the JAX's."""
    jroot, root = jetree.parse_newick(text), etree.parse_newick(text)
    assert _shape(root) == _shape(jroot)
    for fn in ("get_tree", "get_branch", "get_leaves"):
        assert [n.name for n in getattr(etree, fn)(root)] == \
            [n.name for n in getattr(jetree, fn)(jroot)]
    for n in etree.get_tree(root):
        assert (n.up is None) == (n is root)
        assert etree.find_node(root, n.name).name == n.name
    assert etree.find_node(root, "nothere") is None


@pytest.mark.parametrize("text", ["(a:1:2,b);", "((a,b);", "no tree;",
                                  "(a,b)"])
def test_newick_reader_errors(text):
    msgs = []
    for mod in (jetree, etree):
        with pytest.raises(ValueError) as e:
            mod.parse_newick(text)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_read_tree_leaf_without_record(inputs, tmp_path):
    """read_tree leaves a tree leaf with no record at fasta = None, and
    gives each internal node an empty record of its name."""
    aln = _write_fa(tmp_path / "acd.fa", list("ACD"), _combos([], 3))
    for mod in (jetree, etree):
        root = mod.read_tree(inputs["four"], aln)
        leaves = {n.name: n for n in mod.get_leaves(root)}
        assert leaves["B"].fasta is None
        assert leaves["A"].fasta.name == "A"
        assert [(n.name, n.fasta.name, len(n.fasta.seq))
                for n in mod.get_branch(root)] == [
            ("root", "root", 0), ("n1", "n1", 0), ("n2", "n2", 0)]


def test_pfasta_bytes_and_round_trip(tmp_path):
    """write's bytes equal the JAX's; each reads what the other wrote."""
    rng = np.random.default_rng(2307)
    recs = []
    for name, n in (("a", 17), ("b b", 0), ("c", 250)):
        p = rng.random((n, 4)).astype(np.float32)
        p /= np.maximum(p.sum(axis=1, keepdims=True), 1e-9)
        recs.append((name, p))
    pfasta.write(str(tmp_path / "port.pfa"),
                 [pfasta.PFasta(n, s) for n, s in recs])
    jpfasta.write(str(tmp_path / "jax.pfa"),
                  [jpfasta.PFasta(n, s) for n, s in recs])
    with open(tmp_path / "port.pfa", "rb") as a, \
            open(tmp_path / "jax.pfa", "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((pfasta.read, "jax.pfa"), (jpfasta.read, "port.pfa")):
        back = reader(str(tmp_path / path))
        assert [r.name for r in back] == [n for n, _ in recs]
        for r, (_, s) in zip(back, recs):
            assert r.seq.dtype == np.float32 and r.seq.shape == s.shape
            assert np.array_equal(r.seq, s.astype(np.float16).astype(
                np.float32))
    assert pfasta.MAGIC == jpfasta.MAGIC
    bad = tmp_path / "bad.pfa"
    bad.write_bytes(b"notPfa\nEndHeader\n")
    with pytest.raises(ValueError, match="unrecognized pFasta format"):
        pfasta.read(str(bad))
    trailing = tmp_path / "trailing.pfa"
    trailing.write_bytes((tmp_path / "port.pfa").read_bytes() + b"\0\0")
    with pytest.raises(ValueError, match="trailing bytes"):
        pfasta.read(str(trailing))
