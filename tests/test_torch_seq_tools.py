"""The port's ``digestGenome``, ``faToPredictSet``, ``prcompFormat``,
``findAndReplace``, ``bedToFasta`` and ``bedToAminoAcid``
(gonomics_tpu_torch/cli/) on the CPU against the JAX tools: the bytes of
every output file, and the message of every exit, on inputs that a numpy
seed builds here (multi-record FASTA with lower case and N runs and
planted restriction sites, one of them in a record's last bases;
a multiFa alignment with gap and N columns; bed regions on both strands
and of every length modulo 3; TSV tables). Also the library copies under
them: ``codon.translate_seq`` over every codon of A, C, G, T and N in
both cases, and ``dna.compare_seqs_*`` on sequences of unequal length,
against the JAX's.
"""

import itertools
import os

import numpy as np
import pytest

from gonomics_tpu import codon as jcodon
from gonomics_tpu import dna as jdna
from gonomics_tpu.cli import bed_to_amino_acid as jbed_to_amino_acid
from gonomics_tpu.cli import bed_to_fasta as jbed_to_fasta
from gonomics_tpu.cli import digest_genome as jdigest_genome
from gonomics_tpu.cli import fa_to_predict_set as jfa_to_predict_set
from gonomics_tpu.cli import find_and_replace as jfind_and_replace
from gonomics_tpu.cli import prcomp_format as jprcomp_format
from gonomics_tpu.io import bed as jbed
from gonomics_tpu_torch import codon, dna
from gonomics_tpu_torch.cli import bed_to_amino_acid, bed_to_fasta
from gonomics_tpu_torch.cli import digest_genome, fa_to_predict_set
from gonomics_tpu_torch.cli import find_and_replace, prcomp_format
from gonomics_tpu_torch.io import bed

TOOLS = {"digestGenome": (jdigest_genome.main, digest_genome.main),
         "faToPredictSet": (jfa_to_predict_set.main, fa_to_predict_set.main),
         "prcompFormat": (jprcomp_format.main, prcomp_format.main),
         "findAndReplace": (jfind_and_replace.main, find_and_replace.main),
         "bedToFasta": (jbed_to_fasta.main, bed_to_fasta.main),
         "bedToAminoAcid": (jbed_to_amino_acid.main, bed_to_amino_acid.main)}


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
        except Exception as e:  # the JAX tools' ValueError, IndexError
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


def _fa_text(records, width=60) -> str:
    return "".join(f">{name}\n" + "".join(
        seq[i:i + width] + "\n" for i in range(0, len(seq), width))
        for name, seq in records)


def _runs(rng, s: list, n_runs: int, chars, max_len: int) -> None:
    """n_runs runs of 1..max_len of one of chars each, in place."""
    for _ in range(n_runs):
        a = int(rng.integers(0, len(s)))
        k = int(rng.integers(1, max_len + 1))
        c = str(rng.choice(list(chars)))
        s[a:a + k] = [c] * len(s[a:a + k])


def _plant(s: list, at: int, site: str) -> None:
    s[at:at + len(site)] = list(site)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_tools")
    rng = np.random.default_rng(2303)
    f = {}
    # a genome with N runs, lower case and the default enzymes' sites
    # planted, one record ending in each site (the site in the final
    # window, after the one where ``last`` fires), one shorter than every
    # site
    recs = []
    for i, n in enumerate((1500, 730, 410)):
        s = list(rng.choice(list("ACGT"), n))
        _runs(rng, s, 3, "N", 12)
        _runs(rng, s, 3, "acgt", 25)
        for j, site in enumerate(("AGATCT", "AAGCTT", "GAATTC", "GGTGA",
                                  "agatct", "GATC")):
            _plant(s, 40 + j * (n // 7), site)
        recs.append((f"chr{i + 1}", "".join(s)))
    tail = list(rng.choice(list("ACGT"), 120))
    recs.append(("tailGATC", "".join(tail[:-4]) + "GATC"))
    recs.append(("tailBglII", "".join(tail[:-6]) + "AGATCT"))
    recs.append(("tailHind", "".join(tail[:-6]) + "AAGCTT"))
    recs.append(("tailRev", "".join(tail[:-5]) + "TCACC"))
    # a site at the window where ``last`` fires: no cut written there
    recs.append(("atLast", "".join(tail[:-7]) + "AAGCTTG"))
    recs.append(("tiny", "GAT"))
    f["genome"] = _write(tmp / "genome.fa", _fa_text(recs))
    f["recs"] = dict(recs)
    # a multiFa alignment of 5 rows: gap columns, N columns, constant
    # columns, lower case
    ref = list(rng.choice(list("ACGT"), 300))
    rows = [ref]
    for r in range(4):
        q = [str(rng.choice(list("ACGT"))) if rng.random() < 0.15 else c
             for c in ref]
        _runs(rng, q, 4, "-", 5)
        _runs(rng, q, 3, "Nn", 3)
        _runs(rng, q, 2, "acgt", 8)
        rows.append(q)
    rows[0][10:13] = ["-"] * 3
    rows[0][20] = "N"
    f["aln"] = _write(tmp / "aln.fa", _fa_text(
        [(f"s{i}", "".join(q)) for i, q in enumerate(rows)], 50))
    # bed regions on both strands, of every length modulo 3
    regions = []
    for i in range(24):
        c = ("chr1", "chr2", "chr3")[i % 3]
        n = len(f["recs"][c])
        w = int(rng.integers(5, 90))
        s = int(rng.integers(0, n - w))
        regions.append((c, s, s + w, f"r{i}", "+-"[i % 2]))
    f["regions"] = _write(tmp / "regions.bed", "".join(
        f"{c}\t{s}\t{e}\t{n}\t0\t{st}\n" for c, s, e, n, st in regions))
    f["regions3"] = _write(tmp / "regions3.bed", "".join(
        f"{c}\t{s}\t{s + 3 * ((e - s) // 3)}\t{n}\n"
        for c, s, e, n, _ in regions))
    f["missing_bed"] = _write(tmp / "missing.bed",
                              "chr1\t0\t10\tok\t0\t+\nchrZ\t0\t10\tno\t0\t-\n")
    # an N-free genome for bedToAminoAcid, with its regions
    clean = [(c, "".join(rng.choice(list("ACGTacgt"), len(s))))
             for c, s in recs[:3]]
    f["clean"] = _write(tmp / "clean.fa", _fa_text(clean))
    return f


# --- digestGenome ---------------------------------------------------------

@pytest.mark.parametrize("motif", ["MboI", "DnpII", "BglII", "HindIII",
                                   "G^AATTC", "GAT^C", "GG^TGA", "^GATC",
                                   "GATC^"])
def test_digest_genome(files, tmp_path, motif):
    """Each default enzyme, palindromic and non-palindromic custom sites
    (GG^TGA also cuts on the reverse strand) and cuts at either end of
    the site: the JAX tool's bytes."""
    got = _both(tmp_path, "digestGenome",
                lambda d: [files["genome"], motif, d + "/out.bed"])
    lines = got["out.bed"].decode().splitlines()
    assert len(lines) > len(files["recs"])
    if motif == "GG^TGA":
        assert any(ln.endswith("\t-") for ln in lines)


@pytest.mark.parametrize("motif,record", [("MboI", "tailGATC"),
                                          ("BglII", "tailBglII"),
                                          ("HindIII", "tailHind"),
                                          ("GG^TGA", "tailRev")])
def test_digest_genome_cut_in_last_bases(files, tmp_path, motif, record):
    """The ``last`` flag fires one base before the final window, so a
    site in a record's last k bases writes a fragment after the one that
    ends at the record's length (digest_genome.py:58-60)."""
    got = _both(tmp_path, "digestGenome",
                lambda d: [files["genome"], motif, d + "/out.bed"])
    n = len(files["recs"][record])
    rows = [ln.split("\t") for ln in got["out.bed"].decode().splitlines()
            if ln.startswith(record + "\t")]
    ends = [int(r[2]) for r in rows]
    assert n in ends and ends.index(n) < len(ends) - 1


def test_digest_genome_needs_a_caret(files, tmp_path):
    got = _both(tmp_path, "digestGenome",
                lambda d: [files["genome"], "GATC", d + "/out.bed"])
    assert "must have the '^' character" in got and got.endswith("GATC")


# --- faToPredictSet -------------------------------------------------------

@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("stride", [1, 7])
def test_fa_to_predict_set(files, tmp_path, rev, stride):
    """Windows of 25 at strides 1 and 7, with and without the reverse
    complement; range(0, len - window, stride) leaves out each record's
    last full window."""
    args = ["--windowSize", "25", "--stride", str(stride)]
    args += ["--withRevComp"] if rev else []
    got = _both(tmp_path, "faToPredictSet",
                lambda d: args + [files["genome"], d + "/out.txt"])
    lines = got["out.txt"].decode().splitlines()
    want = sum(len(range(0, len(s) - 25, stride))
               for s in files["recs"].values())
    assert len(lines) == want
    assert all(len(ln.split("\t")) == 2 + rev for ln in lines)
    last = len(files["recs"]["chr3"]) - 25
    assert not any(ln.startswith(f"chr3:{last}-") for ln in lines)


def test_fa_to_predict_set_defaults(files, tmp_path):
    """The default window of 400 at stride 1: records of 400 bases or
    fewer give nothing."""
    got = _both(tmp_path, "faToPredictSet",
                lambda d: [files["genome"], d + "/out.txt"])
    assert got["out.txt"].count(b"\n") == sum(
        max(len(s) - 400, 0) for s in files["recs"].values())


# --- prcompFormat ---------------------------------------------------------

@pytest.mark.parametrize("verbose", [False, True])
def test_prcomp_format(files, tmp_path, verbose):
    """Gap and N columns and constant columns dropped; --verbose taken
    and ignored."""
    args = ["--verbose"] if verbose else []
    got = _both(tmp_path, "prcompFormat",
                lambda d: args + [files["aln"], d + "/out.txt"])
    lines = got["out.txt"].decode().splitlines()
    assert len(lines) == 6
    width = len(lines[0].split("\t")) - 1
    assert width % 4 == 0 and 0 < width < 4 * 300
    assert all(len(ln.split("\t")) == width + 1 for ln in lines[1:])


# --- findAndReplace -------------------------------------------------------

@pytest.fixture(scope="module")
def table(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("find_replace")
    rng = np.random.default_rng(2304)
    words = ["chr1", "chr2", "chrX", "geneA", "geneB", "a.b", "x1"]
    rows = ["\t".join(str(rng.choice(words)) for _ in range(4))
            for _ in range(40)]
    f = {"tab": _write(tmp / "in.tsv", "".join(r + "\n" for r in rows)),
         "comma": _write(tmp / "in.csv",
                         "".join(r.replace("\t", ",") + "\n" for r in rows))}
    # insertion order matters: chr1 -> chr2 then chr2 -> chrY
    f["pairs"] = _write(tmp / "pairs.tsv", "chr1\tchr2\nchr2\tchrY\n"
                        "geneA\tgeneZ\n")
    f["pairs_colon"] = _write(tmp / "pairs.txt", "chr1:chr2\nchr2:chrY\n"
                              "geneA:geneZ\n")
    f["regex"] = _write(tmp / "regex.tsv", "chr[12]\tC\n^gene\tG$1\n"
                        r"a\.b" + "\tdot\n")
    f["absent"] = _write(tmp / "absent.tsv", "nothere\tx\n")
    f["three"] = _write(tmp / "three.tsv", "chr1\tchr2\tchr3\n")
    f["dup"] = _write(tmp / "dup.tsv", "chr1\tA\nchr1\tB\n")
    return f


@pytest.mark.parametrize("case", ["lines", "column0", "column2", "regex",
                                  "comma_column", "colon_pairs",
                                  "both_delims"])
def test_find_and_replace(table, tmp_path, case):
    """Whole-line replacement in the table's order, one column, -regex
    with a literal replacement, and both delimiters."""
    args = {"lines": [table["tab"], table["pairs"]],
            "column0": [table["tab"], table["pairs"], "-column", "0"],
            "column2": [table["tab"], table["pairs"], "-column", "2"],
            "regex": [table["tab"], table["regex"], "-regex"],
            "comma_column": [table["comma"], table["pairs"], "-column", "1",
                             "-inFileDelim", ","],
            "colon_pairs": [table["tab"], table["pairs_colon"],
                            "-findReplaceDelim", ":"],
            "both_delims": [table["comma"], table["pairs_colon"],
                            "-inFileDelim", ",", "-findReplaceDelim", ":"],
            }[case]
    got = _both(tmp_path, "findAndReplace",
                lambda d: [args[0], args[1], d + "/out.txt", *args[2:]])
    assert got["out.txt"].count(b"\n") == 40
    if case == "lines":
        assert b"chr1" not in got["out.txt"] and b"chr2" not in got["out.txt"]


@pytest.mark.parametrize("case", ["regex_column", "absent", "three", "dup"])
def test_find_and_replace_exits(table, tmp_path, case):
    args = {"regex_column": [table["regex"], "-regex", "-column", "1"],
            "absent": [table["absent"]], "three": [table["three"]],
            "dup": [table["dup"]]}[case]
    got = _both(tmp_path, "findAndReplace",
                lambda d: [table["tab"], args[0], d + "/out.txt", *args[1:]])
    assert isinstance(got, str) and got.startswith("Error")


# --- bedToFasta -----------------------------------------------------------

@pytest.mark.parametrize("rev", [False, True])
def test_bed_to_fasta(files, tmp_path, rev):
    """Each region's bases under its name; with -revComp the regions on
    - reverse-complemented and named _RevComp."""
    args = ["-revComp"] if rev else []
    got = _both(tmp_path, "bedToFasta",
                lambda d: [files["genome"], files["regions"],
                           d + "/out.fa", *args])
    text = got["out.fa"].decode()
    assert text.count(">") == 24
    assert text.count("_RevComp") == (12 if rev else 0)


def test_bed_to_fasta_missing_chrom(files, tmp_path):
    got = _both(tmp_path, "bedToFasta",
                lambda d: [files["genome"], files["missing_bed"],
                           d + "/out.fa", "-revComp"])
    assert got == "Chrom not found in fasta"


# --- bedToAminoAcid -------------------------------------------------------

@pytest.mark.parametrize("regions", ["regions", "regions3"])
def test_bed_to_amino_acid(files, tmp_path, regions):
    """Regions whose lengths are and are not multiples of 3, on three
    chromosomes, all read from the first record."""
    got = _both(tmp_path, "bedToAminoAcid",
                lambda d: [files[regions], files["clean"], d + "/out.txt"])
    lines = got["out.txt"].decode().splitlines()
    with open(files[regions]) as f:
        spans = [int(r[2]) - int(r[1]) for r in
                 (ln.split("\t") for ln in f)]
    assert len(lines) == sum(n // 3 for n in spans)
    assert set(lines) <= set(codon.AA_LONG)


def test_bed_to_amino_acid_reads_the_first_record(files, tmp_path):
    """A region on chr2 translates chr1's bases at those coordinates."""
    bed_path = _write(tmp_path / "chr2.bed", "chr2\t30\t60\n")
    got = _both(tmp_path, "bedToAminoAcid",
                lambda d: [bed_path, files["clean"], d + "/out.txt"])
    with open(files["clean"]) as f:
        first = "".join(f.read().split(">")[1].splitlines()[1:])
    want = codon.translate_seq(dna.from_string(first[30:60]))
    assert got["out.txt"].decode().split() == [codon.AA_LONG[a]
                                                for a in want]


def test_bed_to_amino_acid_n_exits(files, tmp_path):
    """A region over an N raises the JAX's ValueError."""
    seq = files["recs"]["chr1"]
    at = seq.index("N")
    bed_path = _write(tmp_path / "n.bed", f"chr1\t{at - at % 3}\t{at + 6}\n")
    got = _both(tmp_path, "bedToAminoAcid",
                lambda d: [bed_path, files["genome"], d + "/out.txt"])
    assert got == "ValueError: cannot translate non-ACGT bases"


# --- the library copies ---------------------------------------------------

def test_translate_every_codon():
    """Every codon of A, C, G, T and N in both cases: the JAX's amino
    acid, or its ValueError; and the string helpers on the 64 codons."""
    letters = "ACGTNacgtn"
    for c in itertools.product(letters, repeat=3):
        s = "".join(c)
        out = []
        for mod, d in ((jcodon, jdna), (codon, dna)):
            try:
                out.append(mod.translate_seq(d.from_string(s)).tolist())
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], s
    every = "".join("".join(c) for c in itertools.product("ACGT", repeat=3))
    for fn in ("translate_seq", "translate_seq_to_ter",
               "translate_to_short_string"):
        want = getattr(jcodon, fn)(jdna.from_string(every))
        got = getattr(codon, fn)(dna.from_string(every))
        assert np.array_equal(got, want)
    aas = codon.translate_seq(dna.from_string(every))
    assert codon.to_string(aas) == jcodon.to_string(aas)
    assert codon.to_short_string(aas) == jcodon.to_short_string(aas)
    assert codon.AA_LONG == jcodon.AA_LONG
    assert codon.AA_SHORT == jcodon.AA_SHORT
    assert [codon.one_letter_to_aa(b) for b in codon.AA_SHORT] == list(
        range(21))
    assert codon.is_synonymous(dna.from_string("CTA"), dna.from_string("TTG"))
    assert not codon.is_synonymous(dna.from_string("ATG"),
                                   dna.from_string("ATA"))


@pytest.mark.parametrize("a,b", [("ACGT", "ACG"), ("ACG", "ACGT"),
                                 ("acgt", "ACGT"), ("ACGa", "ACGTT"),
                                 ("", "A"), ("", ""), ("TTT", "TTA"),
                                 ("AAn", "AAN"), ("A-C", "ANC"),
                                 ("GATC", "GATC")])
def test_compare_seqs(a, b):
    """compare_seqs_case_sensitive and compare_seqs_ignore_case, on
    unequal lengths too, return the JAX's -1, 0 or 1."""
    x, y = dna.from_string(a), dna.from_string(b)
    for fn in ("compare_seqs_case_sensitive", "compare_seqs_ignore_case"):
        assert getattr(dna, fn)(x, y) == getattr(jdna, fn)(x, y)


def test_bed_strands():
    assert (bed.POSITIVE, bed.NEGATIVE, bed.NONE) == (
        jbed.POSITIVE, jbed.NEGATIVE, jbed.NONE)
