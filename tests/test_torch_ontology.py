"""The port's ontology library and its six tools
(gonomics_tpu_torch/ontology/{__init__,obo,gaf}.py and cli/ontology_tools.py,
cli/obo_to_dot.py, cli/ontology_histogram.py, cli/assign_genome_space.py)
on the CPU against the JAX package.

The inputs are built here from numpy seeds: an OBO DAG of 40 terms with
alt ids, an obsolete term, ``#`` lines, a ``[Typedef]`` and an
unterminated last stanza; GAF files of 15-17 fields with NOT qualifiers,
duplicates, ``#`` and blank lines; TSS beds and a GTF on two chroms;
bedpe contacts; query beds. Every public name of the three modules is
held to the JAX's: records field by field (the DAG's links by id, since
``Obo`` and ``Ontology`` compare and print recursively without end),
beds by their fields, floats by their bits; every tool's written files,
stdout and exit messages to the JAX tool's bytes. Each reference quirk
the port keeps has a case. Also: chip_smoke's ``onto_straw_checks`` on
the files the JAX tools write from ``onto_straw_inputs`` at a small size.
"""

import math
import os
import struct
import sys

import numpy as np
import pytest

from gonomics_tpu import ontology as jont
from gonomics_tpu.cli import assign_genome_space as jags
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.cli import ontology_tools as jtools
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import bedpe as jbedpe
from gonomics_tpu.io import chrom_info as jci
from gonomics_tpu.ontology import gaf as jgaf
from gonomics_tpu.ontology import obo as jobo
from gonomics_tpu_torch import ontology as tont
from gonomics_tpu_torch.cli import assign_genome_space as tags
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.cli import ontology_tools as ttools
from gonomics_tpu_torch.io import bed as tbed
from gonomics_tpu_torch.io import bedpe as tbedpe
from gonomics_tpu_torch.io import chrom_info as tci
from gonomics_tpu_torch.ontology import gaf as tgaf
from gonomics_tpu_torch.ontology import obo as tobo

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SIDES = (("jax", jobo, jgaf, jont, jbed, jbedpe, jci),
         ("port", tobo, tgaf, tont, tbed, tbedpe, tci))
SIZES = (("chr1", 6000), ("chr2", 3000))
NAMESPACES = ("biological_process", "molecular_function",
              "cellular_component")


def _write(path, lines):
    path.write_text("".join(ln + "\n" for ln in lines))
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _bits(x):
    return struct.pack("<d", x)


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, KeyError, IndexError) as e:
        return type(e).__name__, str(e)


def obo_lines(n_terms=40, seed=3401):
    """A header (with a ``#`` line, kept) and n_terms stanzas: term 0 the
    root, every other term 1-2 parents among the earlier ones, every 5th
    an alt id, synonyms, xrefs, relationships, comments and other
    fields; ``#`` lines between and inside stanzas; an obsolete root; a
    ``[Typedef]``; and a last stanza with no blank line after it."""
    rng = np.random.default_rng(seed)
    lines = ["format-version: 1.2", "data-version: test/2026",
             "# a comment in the header", "ontology: go", ""]
    for i in range(n_terms):
        lines += ["[Term]", f"id: GO:{i:07d}", f"name: term {i}",
                  f"namespace: {NAMESPACES[i % 3]}",
                  f'def: "definition {i}." [GOC:test]']
        if i % 5 == 2:
            lines.append(f"alt_id: GO:9{i:06d}")
        if i % 4 == 1:
            lines.append(f'synonym: "syn {i}" EXACT []')
        if i % 6 == 3:
            lines.append(f"xref: Wikipedia:T{i}")
        if i:
            k = 1 + int(rng.random() < 0.4)
            for p in sorted(set(rng.integers(0, i, k).tolist())):
                lines.append(f"is_a: GO:{p:07d} ! term {p}")
        if i % 7 == 4:
            lines.append(f"relationship: part_of GO:{i // 2:07d}")
        if i % 9 == 5:
            lines += [f"comment: note {i}", "# a comment inside a stanza"]
        if i % 8 == 6:
            lines += ["subset: goslim_generic", "created_by: tester"]
        lines.append("")
        if i % 10 == 9:
            lines.append("# a comment between stanzas")
    lines += ["[Term]", "id: GO:0999999", "name: obsolete thing",
              "namespace: biological_process", 'def: "gone." []',
              "is_obsolete: true", "",
              "[Typedef]", "id: part_of", "name: part of",
              "is_transitive: true", "",
              "[Term]", "id: GO:0888888", "name: never read",
              "namespace: biological_process", 'def: "unterminated." []']
    return lines


GENES = [f"gene{i}" for i in range(12)]


def gaf_lines(obo_ids, seed=3402, n=60, genes=GENES):
    """A GAF of n records over obo_ids, an alt id and an id the OBO lacks:
    15, 16 or 17 fields, NOT qualifiers (and a NOTE one), duplicate
    (GO id, symbol) pairs, ``!`` header lines, ``#`` and blank lines."""
    rng = np.random.default_rng(seed)
    ids = list(obo_ids) + ["GO:9000002", "GO:7777777"]
    quals = ("involved_in", "NOT|involved_in", "enables", "NOTE|enables",
             "contributes_to|NOT", "located_in")
    lines = ["!gaf-version: 2.2", "!generated-by: test"]
    pairs = []
    for i in range(n):
        if pairs and rng.random() < 0.2:
            go, sym = pairs[int(rng.integers(0, len(pairs)))]
        else:
            go = ids[int(rng.integers(0, len(ids)))]
            sym = genes[int(rng.integers(0, len(genes)))]
            pairs.append((go, sym))
        w = ["UniProtKB", f"P{i:05d}", sym,
             quals[int(rng.integers(0, len(quals)))], go, "PMID:1",
             "IEA", "", "PFC"[i % 3], f"protein {i}", f"syn{i}", "protein",
             "taxon:9606", "20260101", "GO_Central"]
        w += [[], ["ext"], ["ext", f"UniProtKB:P{i:05d}-1"]][i % 3]
        lines.append("\t".join(w))
        if i % 17 == 3:
            lines += ["# a comment", ""]
    return lines


def tss_lines(seed=3403, per_chrom=(7, 4), genes=GENES):
    """TSS beds, 4 fields, on SIZES' chroms, sorted, named from genes
    (two names twice; one lower-case gene upper-cased)."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for (chrom, size), n in zip(SIZES, per_chrom):
        for s in np.sort(rng.choice(np.arange(100, size - 100), n,
                                    replace=False)):
            name = genes[k % len(genes)]
            out.append(f"{chrom}\t{s}\t{s + 1}\t{name}")
            k += 1
    out[3] = out[3].replace("gene3", "GENE3")
    return out


def contact_lines(tss, seed=3404, n=30):
    """bedpe contacts, 8 fields, each foot 200-2000 bp wide; cis on chr1
    and chr2, and one whose a foot is on a chrom with no TSS (skipped)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        chrom, size = SIZES[i % 2]
        a = int(rng.integers(0, size - 2000))
        b = int(rng.integers(0, size - 2000))
        wa, wb = (int(x) for x in rng.integers(200, 2000, 2))
        out.append(f"{chrom}\t{a}\t{a + wa}\t{chrom}\t{b}\t{b + wb}\t.\t"
                   f"{int(rng.integers(1, 50))}")
    out.append("chrX\t10\t500\tchrX\t900\t1400\t.\t3")
    return out


def query_lines(seed=3405, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        chrom, size = SIZES[i % 2]
        s = int(rng.integers(0, size - 300))
        out.append(f"{chrom}\t{s}\t{s + int(rng.integers(1, 300))}")
    return out


def gtf_lines(seed=3406):
    """genes on SIZES' chroms with 1-2 transcripts on either strand, two
    transcripts of one gene sharing a start (merged to one TSS)."""
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for chrom, size in SIZES:
        for s in range(300, size - 600, 900):
            gs = s + int(rng.integers(0, 200))
            ge = gs + int(rng.integers(100, 400))
            st = "+-"[int(rng.integers(0, 2))]
            att = f'gene_id "G{k}"; gene_name "{GENES[k % len(GENES)]}";'
            out.append(f"{chrom}\tt\tgene\t{gs}\t{ge}\t.\t{st}\t.\t{att}")
            for t in range(1 + k % 2):
                ts = gs if t == 0 or k % 4 == 1 else gs + 37
                ta = att + f' transcript_id "G{k}.{t}";'
                out.append(f"{chrom}\tt\ttranscript\t{ts}\t{ge}\t.\t{st}\t.\t"
                           f"{ta}")
                out.append(f"{chrom}\tt\texon\t{ts}\t{ge}\t.\t{st}\t.\t{ta}"
                           f' exon_number "1"; exon_id "G{k}.{t}.e";')
            k += 1
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ontology")
    obo = obo_lines()
    ids = [ln[4:] for ln in obo if ln.startswith("id: GO:")][:-1]
    tss = tss_lines()
    out = {
        "in.obo": _write(d / "in.obo", obo),
        "a.gaf": _write(d / "a.gaf", gaf_lines(ids)),
        "b.gaf": _write(d / "b.gaf", gaf_lines(ids, seed=3407, n=40)),
        "tss.bed": _write(d / "tss.bed", tss),
        "genes.gtf": _write(d / "genes.gtf", gtf_lines()),
        "chrom.sizes": _write(d / "chrom.sizes",
                              [f"{c}\t{n}" for c, n in SIZES]),
        "contacts.bedpe": _write(d / "contacts.bedpe", contact_lines(tss)),
        "empty.bedpe": _write(d / "empty.bedpe", []),
        "queries.bed": _write(d / "queries.bed", query_lines())}
    out["gafs.txt"] = _write(d / "gafs.txt", [out["a.gaf"], out["b.gaf"]])
    out["ids"] = ids
    return out


def _obo_rows(terms):
    return [(k, t.id, t.name, t.namespace, t.definition, t.is_obsolete,
             t.is_a, t.synonyms, t.xrefs, t.alt_ids, t.relationships,
             t.comments, list(t.other_fields.items()),
             [p.id for p in t.parents], [c.id for c in t.children],
             t.subtree_size) for k, t in terms.items()]


def _ont_rows(terms):
    return [(k, t.id, t.name, [p.id for p in t.parents],
             [c.id for c in t.children], t.genes) for k, t in terms.items()]


def _beds(records):
    return [tuple(vars(b).values()) for b in records]


def _bed_records(mod, lines):
    return [mod.process_bed_line(ln) for ln in lines]


# --- obo.py ---

@pytest.mark.parametrize("force", [False, True])
def test_obo_read_equals_jax(files, force):
    """Terms, fields, DAG links and the header as the JAX reads them: the
    header runs to the first [Term] and keeps its # line; # lines after
    it are skipped; the [Typedef] and the unterminated last stanza are
    absent."""
    j, jh = jobo.read(files["in.obo"], force)
    t, th = tobo.read(files["in.obo"], force)
    assert _obo_rows(t) == _obo_rows(j)
    assert th == jh
    assert "# a comment in the header" in th and th[-1] == ""
    assert "GO:0888888" not in t and "part_of" not in t
    assert len(t) == 41 and "GO:0999999" in t


@pytest.mark.parametrize("lines", [
    ["[Term]", "id: GO:1", "id: GO:2", "name: a", "namespace: b",
     "def: c"],
    ["[Term]", "id: GO:1", "name: a", "name: a2", "namespace: b",
     "def: c"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b", "namespace: b2",
     "def: c"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b", "def: c", "def: d"],
    ["[Term]", "id: GO:1", "namespace: b", "def: c"],
    ["[Term]", "id: GO:1", "name: a", "def: c"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b"],
    ["[Term]", "name: a", "namespace: b", "def: c"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b", "def: c",
     "is_obsolete: false"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b", "def: c",
     "a line with no separator"],
    ["[Term]", "id: GO:1", "name: a", "namespace: b", "def: c",
     "is_a: GO:404 ! missing"]],
    ids=["two_ids", "two_names", "two_namespaces", "two_defs", "no_name",
         "no_namespace", "no_def", "no_id", "obsolete_false", "no_colon",
         "missing_parent"])
@pytest.mark.parametrize("force", [False, True])
def test_obo_term_errors_equal_jax(tmp_path, lines, force):
    """_process_term's and _build_tree's exits, and what -force lets
    through, as in the JAX."""
    path = _write(tmp_path / "t.obo", ["format-version: 1.2"] + lines + [""])
    j, t = _outcome(jobo.read, path, force), _outcome(tobo.read, path, force)
    assert t[0] == j[0]
    if t[0] == "ok":
        assert _obo_rows(t[1][0]) == _obo_rows(j[1][0])
    else:
        assert t == j


def test_obo_writers_equal_jax(files, tmp_path):
    """write, to_string, to_dot, find_tree_roots, number_of_descendents
    and subtree_report against the JAX's."""
    out = {}
    for side, obo, *_ in SIDES:
        d = tmp_path / side
        d.mkdir()
        terms, header = obo.read(files["in.obo"])
        obo.write(str(d / "w.obo"), terms, header)
        obo.to_dot(str(d / "all.dot"), terms)
        obo.number_of_descendents(terms)
        obo.subtree_report(str(d / "report.txt"), terms)
        roots = [r.id for r in obo.find_tree_roots(terms)]
        strings = [obo.to_string(v) for v in terms.values()]
        files_ = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files_, roots, strings, _obo_rows(terms))
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["GO:0000000", "GO:0999999"]
    assert b"is_obsolete: true" in out["port"][0]["w.obo"]


def test_obo_to_dot_writes_visited_child_edges(tmp_path):
    """_term_to_dot writes an edge to a child it visited before (a term
    with two parents gets two edges, its node once)."""
    lines = ["[Term]", "id: A", "name: a", "namespace: n", "def: d", "",
             "[Term]", "id: B", "name: b", "namespace: n", "def: d",
             "is_a: A", "", "[Term]", "id: C", "name: c", "namespace: n",
             "def: d", "is_a: A", "is_a: B", ""]
    path = _write(tmp_path / "t.obo", lines)
    got = {}
    for side, obo, *_ in SIDES:
        obo.to_dot(str(tmp_path / f"{side}.dot"), obo.read(path)[0])
        got[side] = _read(str(tmp_path / f"{side}.dot"))
    assert got["port"] == got["jax"]
    text = got["port"].decode()
    assert text.count('-> "C"') == 2 and text.count('"C" [label') == 1


@pytest.mark.parametrize("term", ["GO:0000003", "GO:9000007", "GO:0000000",
                                  "GO:0999999", "GO:1234567"])
def test_obo_to_dot_cli_equals_jax(files, tmp_path, capsys, term):
    """oboToDot through the umbrella on a term, an alt id, the root, the
    obsolete term and an unknown term (the JAX's exit message)."""
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        path = str(tmp_path / f"{side}.dot")
        res = _outcome(mod.main, ["oboToDot", files["in.obo"], term, path])
        got[side] = (res, _read(path) if os.path.exists(path) else None,
                     capsys.readouterr().out)
    assert got["port"] == got["jax"]
    if term == "GO:1234567":
        assert got["port"][0] == ("SystemExit", "Input term not found in "
                                  "Obo file. Term: GO:1234567")
    elif term == "GO:9000007":
        assert got["port"][1].startswith(b'digraph G {\n"GO:0000007"')


# --- gaf.py ---

def test_gaf_read_write_equal_jax(files, tmp_path):
    """read (header, # and blank lines), Gaf.to_string, write and
    remove_duplicates."""
    out = {}
    for side, _, gaf, *_ in SIDES:
        recs, header = gaf.read(files["a.gaf"])
        gaf.write(str(tmp_path / f"{side}.gaf"), recs, header)
        uniq = gaf.remove_duplicates(recs)
        out[side] = ([vars(r) for r in recs], header,
                     [r.to_string() for r in uniq],
                     _read(str(tmp_path / f"{side}.gaf")))
    assert out["port"] == out["jax"]
    assert len(out["port"][2]) < len(out["port"][0]) == 60


@pytest.mark.parametrize("n", [14, 15, 16, 17, 18])
def test_gaf_field_counts_equal_jax(n):
    line = "\t".join(f"f{i}" for i in range(n))
    j, t = _outcome(jgaf._process_line, line), \
        _outcome(tgaf._process_line, line)
    assert (t[0], vars(t[1]) if t[0] == "ok" else t[1]) == \
        (j[0], vars(j[1]) if j[0] == "ok" else j[1])


@pytest.mark.parametrize("remove_not", [False, True])
def test_gaf_filter_equals_jax(files, tmp_path, capsys, remove_not):
    """gafFilter through the umbrella; -removeNot tests "NOT" as a
    substring, so NOTE|enables goes too."""
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        path = str(tmp_path / f"{side}.gaf")
        mod.main(["gafFilter", files["a.gaf"], path]
                 + ["-removeNot"] * remove_not)
        got[side] = (_read(path), capsys.readouterr().out)
    assert got["port"] == got["jax"]
    text = got["port"][0].decode()
    assert text.startswith("!gaf-version: 2.2\n!generated-by: test\n")
    assert ("NOTE|enables" in text) == (not remove_not)


# --- the tools over OBO and GAF ---

@pytest.mark.parametrize("argv", [["mapping"], ["mapping", "-force"],
                                  ["bogus"], []])
def test_obo_tools_equal_jax(files, tmp_path, capsys, argv):
    """oboTools mapping: a row a complete stanza in file order; a missing
    or unknown subcommand exits with the JAX's message."""
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        path = str(tmp_path / f"{side}.tsv")
        args = argv[:1] + ([files["in.obo"], path] + argv[1:] if argv
                           else [])
        res = _outcome(mod.main, ["oboTools"] + args)
        got[side] = (res, _read(path) if os.path.exists(path) else None,
                     capsys.readouterr().out)
    assert got["port"] == got["jax"]
    if argv[:1] == ["mapping"]:
        rows = got["port"][1].decode().splitlines()
        assert rows[0] == "GO:0000000\tterm 0" and len(rows) == 41
        assert rows[-1] == "GO:0999999\tobsolete thing"


def test_ontology_histogram_equals_jax(files, tmp_path, capsys):
    """ontologyHistogram over two GAFs: duplicates removed per file only
    (a pair in both files counts twice), ids sorted as strings, terms
    without genes left out."""
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        path = str(tmp_path / f"{side}.tsv")
        mod.main(["ontologyHistogram", files["in.obo"], files["gafs.txt"],
                  path])
        got[side] = (_read(path), capsys.readouterr().out)
    assert got["port"] == got["jax"]
    counts = {}
    for g in (files["a.gaf"], files["b.gaf"]):
        pairs = {(w[4], w[2]) for w in (ln.split("\t") for ln in
                                        open(g).read().splitlines())
                 if len(w) >= 15}
        for go, _ in pairs:
            counts[go] = counts.get(go, 0) + 1
    want = "".join(f"{k}\t{v}\n" for k, v in sorted(counts.items())
                   if k in files["ids"])
    assert got["port"][0].decode() == want


# --- ontology/__init__.py: terms and genes ---

def test_ontology_terms_and_genes_equal_jax(files):
    """obo_to_ontology, gene_assignments_from_gaf and
    genes_to_ontologies."""
    out = {}
    for side, obo, gaf, ont, *_ in SIDES:
        terms = ont.obo_to_ontology(obo.read(files["in.obo"])[0])
        ont.gene_assignments_from_gaf(gaf.read(files["a.gaf"])[0], terms)
        by_gene = ont.genes_to_ontologies(terms)
        out[side] = (_ont_rows(terms),
                     [(g, [o.id for o in v]) for g, v in by_gene.items()])
    assert out["port"] == out["jax"]
    assert out["port"][1]


# --- fill space ---

def test_fill_space_equal_jax(files):
    """fill_space_no_hidden_value, the merge, the territory pass,
    fill_space_hidden_value and fill_3d_space on the same beds."""
    out = {}
    tss = open(files["tss.bed"]).read().splitlines()
    contacts = open(files["contacts.bedpe"]).read().splitlines()
    for side, _, _, ont, bed, bedpe, ci in SIDES:
        sizes = ci.read_to_map(files["chrom.sizes"])
        one_d = ont.fill_space_no_hidden_value(_bed_records(bed, tss), sizes)
        recs = [bedpe.process_line(ln) for ln in contacts]
        three_d = ont.fill_3d_space(recs, _bed_records(bed, tss), sizes)
        merged, hidden = ont._merge_keep_low_score_and_name(
            _bed_records(bed, tss))
        kept, violation = ont._remove_beds_with_no_territory(merged)
        hv = ont.fill_space_hidden_value(_bed_records(bed, tss), sizes)
        out[side] = (_beds(one_d), _beds(three_d), _beds(merged), hidden,
                     _beds(kept), violation, _beds(hv),
                     [(_beds([r.a, r.b])) for r in recs],
                     _beds(ont._remove_missing_chrom(
                         _bed_records(bed, tss + ["chrZ\t1\t2\tz"]), sizes)))
    assert out["port"] == out["jax"]
    # contacts_to_midpoints mutated the contacts in place
    assert all(b[2] - b[1] == 1 for pair in out["port"][7] for b in pair)


@pytest.mark.parametrize("contacts", [None, []])
def test_fill_3d_space_no_contacts_is_1d(files, contacts):
    """None or an empty list of contacts gives the 1D fill."""
    tss = open(files["tss.bed"]).read().splitlines()
    for side, _, _, ont, bed, _, ci in SIDES:
        sizes = ci.read_to_map(files["chrom.sizes"])
        assert _beds(ont.fill_3d_space(contacts, _bed_records(bed, tss),
                                       sizes)) == \
            _beds(ont.fill_space_no_hidden_value(_bed_records(bed, tss),
                                                 sizes))


def test_fill_space_midpoint_one_base_farther(tmp_path):
    """The 1D boundary is (start + previous TSS end) // 2: with TSSs at 10
    and 21, base 16 goes to the TSS at 10, 6 bases away, where the one at
    21 is 5 away."""
    tss = ["chr1\t10\t11\ta", "chr1\t21\t22\tb"]
    for side, _, _, ont, bed, _, ci in SIDES:
        sizes = {"chr1": ci.ChromInfo("chr1", 40)}
        got = ont.fill_space_no_hidden_value(_bed_records(bed, tss), sizes)
        assert [(b.chrom_start, b.chrom_end, b.name, b.score)
                for b in got] == [(0, 17, "a", 10), (17, 40, "b", 21)]


def test_fill_space_hidden_runs_the_merge_once():
    """The merge runs once: a lower value that c carries back to b in the
    first pass reaches a only in a second, which the reference drops, so
    the JAX and the port both keep a's name on its tile where a merge
    run to convergence would give it c's."""
    rows = [(0, 1, "a", 50), (10, 11, "b", 60), (20, 21, "c", 0)]
    got = {}
    for side, _, _, ont, bed, _, ci in SIDES:
        recs = [bed.Bed("chr1", s, e, n, sc, fields_initialized=5)
                for s, e, n, sc in rows]
        sizes = {"chr1": ci.ChromInfo("chr1", 60)}
        merged, hidden = ont._merge_keep_low_score_and_name(
            [bed.Bed(**vars(r)) for r in recs])
        again, hidden2 = ont._merge_keep_low_score_and_name(
            [bed.Bed(**vars(r)) for r in merged])
        got[side] = (_beds(ont.fill_space_hidden_value(recs, sizes)), hidden,
                     _beds(merged), _beds(again), hidden2)
    assert got["port"] == got["jax"]
    assert got["port"][1] and got["port"][2] != got["port"][3]


@pytest.mark.parametrize("case", [
    ("Died on new chrom.", [("chr1", 0, 1, "a", 0), ("chr1", 30, 31, "b", 0),
                            ("chr2", 5, 6, "c", 0)]),
    ("Died in loop.", [("chr1", 8, 8, "f", 47), ("chr1", 38, 47, "e", 74),
                       ("chr1", 45, 45, "f", 70), ("chr1", 31, 37, "f", 75),
                       ("chr1", 0, -3, "b", 19), ("chr1", 10, 10, "d", 7)]),
    ("Died after loop.", [("chr1", 0, 1, "a", 0),
                          ("chr1", 30, 31, "b", 0)])],
    ids=["new_chrom", "in_loop", "after_loop"])
def test_fill_space_hidden_exits_equal_jax(case):
    """fill_space_hidden_value's three exits (a record past its chrom's
    size; a record that ends before it starts)."""
    msg, rows = case
    got = {}
    for side, _, _, ont, bed, _, ci in SIDES:
        recs = [bed.Bed(c, s, e, n, sc, fields_initialized=5)
                for c, s, e, n, sc in rows]
        sizes = {"chr1": ci.ChromInfo("chr1", 10 if msg != "Died in loop."
                                      else 100),
                 "chr2": ci.ChromInfo("chr2", 10)}
        got[side] = _outcome(ont.fill_space_hidden_value, recs, sizes)
    assert got["port"] == got["jax"] == ("SystemExit", msg)


def test_fill_3d_space_foot_with_no_tile_exits(files):
    """A foot on a chrom with TSSs nowhere (b on chrX while a is on chr1)
    hits no tile and exits with the JAX's message; a contact whose a foot
    is on such a chrom is skipped."""
    tss = open(files["tss.bed"]).read().splitlines()
    got = {}
    for side, _, _, ont, bed, bedpe, ci in SIDES:
        sizes = ci.read_to_map(files["chrom.sizes"])
        recs = [bedpe.process_line("chr1\t100\t300\tchrX\t100\t300\t.\t1")]
        got[side] = _outcome(ont.fill_3d_space, recs, _bed_records(bed, tss),
                             sizes)
    assert got["port"] == got["jax"] == (
        "SystemExit", "Space Filled bed should return one nearest bed "
        "entry, returned 0.")


# --- enrichment ---

def _binomial_cases():
    rng = np.random.default_rng(3408)
    cases = [(n, 0, p) for n, p in ((10, 0.3), (2000, 0.5))]
    for _ in range(40):
        n = int(rng.integers(1, 300))
        p = float(rng.choice([rng.uniform(1e-4, 0.05), rng.uniform(0, 1)]))
        cases.append((n, int(rng.integers(1, n + 1)), p))
    return cases


def test_binomial_right_summation_log_bits():
    """k = 0 gives 0.0; the normal tail where n·p and n·(1-p) exceed 10;
    the exact sum elsewhere: every value by its 64 bits, and a far tail's
    ValueError as the JAX's."""
    branches = set()
    for n, k, p in _binomial_cases():
        j = _outcome(jont.binomial_right_summation_log, n, k, p)
        t = _outcome(tont.binomial_right_summation_log, n, k, p)
        assert t[0] == j[0] and (_bits(t[1]) == _bits(j[1]) if t[0] == "ok"
                                 else t == j), (n, k, p)
        branches.add("zero" if k == 0 else "raise" if t[0] != "ok" else
                     "normal" if n * p > 10 and n * (1 - p) > 10 else "exact")
    assert branches == {"zero", "normal", "exact", "raise"}
    assert tont.binomial_right_summation_log(2000, 0, 0.5) == 0.0


def test_binomial_right_summation_log_erfc_underflow_raises():
    """Where erfc underflows to 0 (its argument z / sqrt(2) above ~27.2),
    math.log raises ValueError in both packages; at z / sqrt(2) = 25.5
    both still give the same bits."""
    n, p = 1000, 0.05
    mu, sigma = n * p, math.sqrt(n * p * (1 - p))
    k = int(mu + 0.5 + 28 * math.sqrt(2) * sigma) + 1
    for mod in (jont, tont):
        with pytest.raises(ValueError, match="math domain error"):
            mod.binomial_right_summation_log(n, k, p)
    k_ok = int(mu + 0.5 + 25.5 * math.sqrt(2) * sigma)
    assert math.isfinite(tont.binomial_right_summation_log(n, k_ok, p))
    assert _bits(tont.binomial_right_summation_log(n, k_ok, p)) == \
        _bits(jont.binomial_right_summation_log(n, k_ok, p))


def _run_tool(mod, argv, d):
    """Run argv through an umbrella in directory d; the files written
    there, and the outcome."""
    d.mkdir()
    res = _outcome(mod.main, [a.replace("@", str(d) + "/") for a in argv])
    return res, {n: _read(str(d / n)) for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("genes,contacts,flags", [
    ("tss.bed", "", []), ("tss.bed", "contacts.bedpe", []),
    ("genes.gtf", "contacts.bedpe", ["-force"]),
    ("genes.gtf", "empty.bedpe", ["-geneEnrichments", "-termEnrichments"])],
    ids=["bed_1d", "bed_3d", "gtf_3d", "gtf_empty_contacts"])
def test_ontology_enrichment_equals_jax(files, tmp_path, capsys, genes,
                                        contacts, flags):
    """ontologyEnrichment through the umbrella: the positional bed, gene
    proportions, term proportions and enrichments, byte for byte. The
    two enrichment flags are store_true with a default of True, so
    passing them changes nothing."""
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        argv = ["ontologyEnrichment", files["queries.bed"],
                files["chrom.sizes"], files[genes], files["a.gaf"],
                files["in.obo"], "@out.bed"] + flags
        if contacts:
            argv += ["-contactFile", files[contacts]]
        out[side] = (*_run_tool(mod, argv, tmp_path / side),
                     capsys.readouterr().out)
    assert out["port"] == out["jax"]
    res, written, _ = out["port"]
    assert res[0] == "ok" and sorted(written) == [
        "out.bed", "out.geneProportions.txt", "out.termEnrichment.txt",
        "out.termProportions.txt"]
    rows = [ln.split("\t") for ln in
            written["out.bed"].decode().splitlines()]
    assert all(len(r) >= 6 and r[5] == "." for r in rows)


def test_three_d_great_upper_case_name_counts_only_in_proportions(
        tmp_path):
    """A TSS named GENE3 where the GAF says gene3: the tile counts toward
    gene3's proportion (keyed by name.upper()) but a query on it never
    counts toward k (looked up by the name as written), so the term's
    enrichment is 0.0 (k = 0). The bed's records gain fields 8 + k,
    strand "." and the term names."""
    sizes = _write(tmp_path / "s.sizes", ["chr1\t1000"])
    tss = _write(tmp_path / "t.bed", ["chr1\t100\t101\tGENE3",
                                      "chr1\t700\t701\tgene4"])
    obo = _write(tmp_path / "o.obo", [
        "[Term]", "id: GO:1", "name: one", "namespace: n", "def: d", "",
        "[Term]", "id: GO:2", "name: two", "namespace: n", "def: d", ""])
    gaf = _write(tmp_path / "a.gaf", [
        "\t".join(["D", "1", sym, "q", go] + ["x"] * 10)
        for sym, go in (("gene3", "GO:1"), ("gene4", "GO:2"))])
    queries = _write(tmp_path / "q.bed", ["chr1\t90\t110", "chr1\t120\t130",
                                          "chr1\t690\t710"])
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        got[side] = _run_tool(mod, [
            "ontologyEnrichment", queries, sizes, tss, gaf, obo,
            "@o.bed"], tmp_path / side)
    assert got["port"] == got["jax"]
    w = got["port"][1]
    assert w["o.geneProportions.txt"].decode().splitlines()[1:] == [
        "GENE3\t4.010000e-01", "GENE4\t5.990000e-01"]
    enr = dict(ln.split("\t")[::2] for ln in
               w["o.termEnrichment.txt"].decode().splitlines()[1:])
    assert enr["GO:1"] == "0.000000e+00" and enr["GO:2"] != "0.000000e+00"
    assert w["o.bed"].decode().splitlines() == [
        "chr1\t0\t401\tGENE3\t100\t.", "chr1\t401\t1000\tgene4\t700\t.\ttwo"]


def test_three_d_great_query_off_the_tiles_exits(files, tmp_path):
    """A query whose midpoint hits no tile (a chrom with no TSS) exits
    with the JAX's message, after the positional bed is written."""
    q = _write(tmp_path / "q.bed", ["chr1\t10\t20", "chrX\t10\t20"])
    got = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        got[side] = _run_tool(mod, [
            "ontologyEnrichment", q, files["chrom.sizes"], files["tss.bed"],
            files["a.gaf"], files["in.obo"], "@o.bed"], tmp_path / side)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("SystemExit", "Query overlapped multiple "
                              "regions in filled space.")
    assert sorted(got["port"][1]) == ["o.bed", "o.geneProportions.txt"]


def test_three_d_great_and_write_3d_ontologies_equal_jax(files, tmp_path):
    """three_d_great called directly, and _write_3d_ontologies' mutation
    of the filled records."""
    tss = open(files["tss.bed"]).read().splitlines()
    out = {}
    for side, obo, gaf, ont, bed, bedpe, ci in SIDES:
        d = tmp_path / side
        d.mkdir()
        sizes = ci.read_to_map(files["chrom.sizes"])
        terms, _ = obo.read(files["in.obo"])
        annotations, _ = gaf.read(files["b.gaf"])
        contacts = bedpe.read(files["contacts.bedpe"])
        ont.three_d_great(bed.read(files["queries.bed"]), sizes,
                          files["tss.bed"], contacts, annotations, terms,
                          str(d / "g"), False, True)
        filled = ont.fill_space_no_hidden_value(_bed_records(bed, tss), sizes)
        onts = ont.obo_to_ontology(terms)
        ont.gene_assignments_from_gaf(annotations, onts)
        ont._write_3d_ontologies(str(d / "w.bed"),
                                 ont.genes_to_ontologies(onts), filled)
        out[side] = ({n: _read(str(d / n)) for n in sorted(os.listdir(d))},
                     _beds(filled))
    assert out["port"] == out["jax"]
    assert sorted(out["port"][0]) == ["g", "g.termEnrichment.txt",
                                      "g.termProportions.txt", "w.bed"]
    assert all(b[5] == "." and b[6] == 8 + len(b[7])
               for b in out["port"][1])


# --- assignGenomeSpace ---

@pytest.mark.parametrize("genes,flags", [
    ("genes.gtf", ["--proximity", "@1d.bed"]),
    ("tss.bed", ["--geneBed", "--proximity", "@1d.bed"]),
    ("tss.bed", ["--geneBed", "--contactFile", "contacts.bedpe",
                 "--nearestGeneBed", "@3d.bed", "--proximity", "@1d.bed"]),
    ("genes.gtf", ["--contactFile", "contacts.bedpe", "--nearestGeneBed",
                   "@3d.bed"]),
    ("genes.gtf", ["--contactFile", "empty.bedpe", "--nearestGeneBed",
                   "@3d.bed", "--proximity", "@1d.bed"]),
    ("tss.bed", ["--geneBed", "--contactFile", "contacts.bedpe"])],
    ids=["gtf_1d", "bed_1d", "bed_both", "gtf_3d", "gtf_empty_contacts",
         "no_output"])
def test_assign_genome_space_equals_jax(files, tmp_path, capsys, genes,
                                        flags):
    """assignGenomeSpace through the umbrella (two-dash flags); an empty
    contact file gives the 1D fill's bytes."""
    out = {}
    flags = [files.get(f, f) for f in flags]
    for side, mod in (("jax", jmain), ("port", tmain)):
        argv = ["assignGenomeSpace", *flags, files[genes],
                files["chrom.sizes"]]
        out[side] = (*_run_tool(mod, argv, tmp_path / side),
                     capsys.readouterr().out)
    assert out["port"] == out["jax"]
    written = out["port"][1]
    if "empty.bedpe" in " ".join(flags):
        assert written["3d.bed"] == written["1d.bed"]
    if genes == "genes.gtf" and "1d.bed" in written:
        # two transcripts with one start merge to one TSS
        n_tss = len({(w[0], w[3] if w[6] == "+" else w[4])
                     for w in (ln.split("\t") for ln in
                               open(files["genes.gtf"]).read().splitlines())
                     if w[2] == "transcript"})
        assert written["1d.bed"].count(b"\n") == n_tss


def test_assign_genome_space_function_equals_jax(files, tmp_path):
    """assign_genome_space called directly with every output."""
    got = {}
    for side, mod in (("jax", jags), ("port", tags)):
        d = tmp_path / side
        d.mkdir()
        mod.assign_genome_space(
            files["tss.bed"], files["chrom.sizes"],
            contact_file=files["contacts.bedpe"],
            nearest_gene_bed=str(d / "n.bed"), gene_bed=True,
            output_1d=str(d / "p.bed"))
        got[side] = (_read(str(d / "n.bed")), _read(str(d / "p.bed")))
    assert got["port"] == got["jax"]


def test_ontology_tools_functions_equal_jax(files, tmp_path):
    """obo_tools_mapping, gaf_filter and ontology_enrichment called
    directly."""
    got = {}
    for side, mod in (("jax", jtools), ("port", ttools)):
        d = tmp_path / side
        d.mkdir()
        mod.obo_tools_mapping(files["in.obo"], str(d / "m.tsv"), True)
        mod.gaf_filter(files["b.gaf"], str(d / "f.gaf"), True)
        mod.ontology_enrichment(
            files["queries.bed"], files["chrom.sizes"], files["genes.gtf"],
            files["b.gaf"], files["in.obo"], str(d / "e.bed"),
            contact_file=files["contacts.bedpe"], gene_proportions=False)
        got[side] = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
    assert got["port"] == got["jax"]
    assert "e.geneProportions.txt" not in got["port"]


# --- chip_smoke's gates on the JAX tools' files ---

def test_onto_straw_checks_pass_on_jax_outputs(tmp_path):
    """chip_smoke's onto_straw_checks read the files that the JAX tools
    write from onto_straw_inputs at a small size, and every gate holds."""
    genes = [{"name": f"gene{k}" if k % 7 else "", "chrom": c,
              "strand": "+-"[k % 2],
              "tx": [{"exons": [(s, s + 60)]}, {"exons": [(s + 5, s + 80)]}]}
             for k, (c, s) in enumerate(
                 [("chr1", x) for x in range(500, 59_000, 1500)]
                 + [("chr2", x) for x in range(300, 4_500, 600)])]
    sizes = {"chr1": 60_000, "chr2": 5_000}
    os_in = chip_smoke.onto_straw_inputs(
        str(tmp_path), genes, sizes, terms=60, gaf_lines=(200, 150),
        contacts=300, queries=120, straw_bins=60, straw_distances=6)

    def step(name, *argv):
        jmain.main(list(argv))

    chip_smoke.onto_straw_steps(step, os_in)
    x = chip_smoke.onto_straw_checks(os_in)
    assert chip_smoke.onto_straw_ok(x), x
