"""The port's ``faFindFast``, ``faFilter``, ``gcContent``, ``faInfo``,
``faUniq``, ``faBin``, ``catMultiFa``, ``assemblyStats``, ``locateCG``
and ``countPairOfBases`` (gonomics_tpu_torch/cli/) on the CPU against
the JAX tools: the bytes of every output file, and the message of every
exit, on inputs that a numpy seed builds here (multiFa alignments of two
and three rows with gap runs, N runs and lower case; multi-record FASTA
with N-split contigs; duplicate records; bed regions). faFindFast's
short output is compared on its two paths, the native scan and the numpy
prefix sums with Python formatting, on alignments with and without gaps
(the native scan has a branch of its own for a gap-free alignment).
Also the library copies under them (``numbers.binomial_dist_cache_log10``,
``numbers.logspace``, ``io/fasta.py``'s additions, ``dna.define_base_mask``)
against the JAX's, bit for bit.
"""

import os

import numpy as np
import pytest

from gonomics_tpu import dna as jdna
from gonomics_tpu import numbers as jnumbers
from gonomics_tpu.cli import assembly_stats as jassembly_stats
from gonomics_tpu.cli import cat_multi_fa as jcat_multi_fa
from gonomics_tpu.cli import count_pair_of_bases as jcount_pair_of_bases
from gonomics_tpu.cli import fa_bin as jfa_bin
from gonomics_tpu.cli import fa_filter as jfa_filter
from gonomics_tpu.cli import fa_find_fast as jfa_find_fast
from gonomics_tpu.cli import fa_info as jfa_info
from gonomics_tpu.cli import fa_uniq as jfa_uniq
from gonomics_tpu.cli import gc_content as jgc_content
from gonomics_tpu.cli import locate_cg as jlocate_cg
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.numbers import logspace as jlogspace
from gonomics_tpu_torch import dna, native, numbers
from gonomics_tpu_torch.cli import assembly_stats, cat_multi_fa
from gonomics_tpu_torch.cli import count_pair_of_bases, fa_bin, fa_filter
from gonomics_tpu_torch.cli import fa_find_fast, fa_info, fa_uniq
from gonomics_tpu_torch.cli import gc_content, locate_cg
from gonomics_tpu_torch.io import fasta
from gonomics_tpu_torch.numbers import logspace

TOOLS = {"faFindFast": (jfa_find_fast.main, fa_find_fast.main),
         "faFilter": (jfa_filter.main, fa_filter.main),
         "gcContent": (jgc_content.main, gc_content.main),
         "faInfo": (jfa_info.main, fa_info.main),
         "faUniq": (jfa_uniq.main, fa_uniq.main),
         "faBin": (jfa_bin.main, fa_bin.main),
         "catMultiFa": (jcat_multi_fa.main, cat_multi_fa.main),
         "assemblyStats": (jassembly_stats.main, assembly_stats.main),
         "locateCG": (jlocate_cg.main, locate_cg.main),
         "countPairOfBases": (jcount_pair_of_bases.main,
                              count_pair_of_bases.main)}


def _both(tmp_path, tool: str, argv, chdir=None) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own (its working directory too with chdir), and holds
    their exits and the files they wrote equal; returns the port's
    {file name: bytes}, or its exit: the SystemExit's message, or the
    type and message of any other exception."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        if chdir is not None:
            chdir(d)
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


def _gap_free(rng, n: int, *, with_n: bool):
    """A two-row alignment of n columns with no gap in either row: a
    random reference and a query from it with substitutions, lower-case
    runs and, with with_n, N runs in upper and lower case."""
    ref = "".join(rng.choice(list("ACGT"), n))
    q = [("ACGT"[int(rng.integers(0, 4))] if rng.random() < 0.06 else c)
         for c in ref]
    if with_n:
        _runs(rng, q, n // 150, "Nn", 6)
    for _ in range(n // 100):
        a = int(rng.integers(0, n))
        for i in range(a, min(n, a + int(rng.integers(2, 12)))):
            q[i] = q[i].lower()
    return [("ref", ref), ("seqB", "".join(q))]


def _alignment(rng, n: int, rows: int, *, with_n: bool = True):
    """A multiFa alignment of rows rows of n columns: a random reference
    row with gap runs; each other row from it with substitutions, gap
    runs (at both ends too), N runs and lower-case runs."""
    ref = list(rng.choice(list("ACGT"), n))
    _runs(rng, ref, n // 60, "-", 5)
    out = [("ref", "".join(ref))]
    for r in range(1, rows):
        q = [("ACGT"[int(rng.integers(0, 4))] if rng.random() < 0.06 else c)
             if c != "-" else str(rng.choice(list("ACGT"))) for c in ref]
        _runs(rng, q, n // 50, "-", 7)
        if with_n:
            _runs(rng, q, n // 150, "Nn", 6)
        k = int(rng.integers(1, 4))
        q[:k] = ["-"] * k
        q[-2:] = ["-", "-"]
        low = list(q)
        for _ in range(n // 100):
            a = int(rng.integers(0, n))
            for i in range(a, min(n, a + int(rng.integers(2, 12)))):
                low[i] = low[i].lower()
        out.append((f"seq{'ABCDEFG'[r]}", "".join(low)))
    first = list(out[0][1])
    first[-1] = "-"  # a reference gap at a window's last column
    out[0] = ("ref", "".join(first))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fasta_tools")
    rng = np.random.default_rng(2202)
    f = {}
    aln2 = _alignment(rng, 640, 2)
    aln3 = _alignment(rng, 520, 3)
    f["aln2"] = _write(tmp / "aln2.fa", _fa_text(aln2))
    f["aln3"] = _write(tmp / "aln3.fa", _fa_text(aln3, 50))
    clean = _alignment(rng, 400, 2, with_n=False)
    f["clean"] = _write(tmp / "clean.fa", _fa_text(clean))
    f["gap_free_n"] = _write(tmp / "gap_free_n.fa",
                             _fa_text(_gap_free(rng, 1200, with_n=True)))
    f["gap_free"] = _write(tmp / "gap_free.fa",
                           _fa_text(_gap_free(rng, 300, with_n=False)))
    f["one"] = _write(tmp / "one.fa", _fa_text(aln2[:1]))
    f["uneven"] = _write(tmp / "uneven.fa", _fa_text(
        [aln2[0], (aln2[1][0], aln2[1][1][:-5])]))
    # plain records: N-split contigs, lower case, a record of only N
    recs = []
    for i, n in enumerate((900, 420, 77, 1300, 35)):
        s = list(rng.choice(list("ACGT"), n))
        _runs(rng, s, 3 + i, "N", 20)
        _runs(rng, s, 2, "acgt", 30)
        recs.append((f"chr{i + 1}", "".join(s)))
    recs.append(("chrN", "N" * 40))
    f["genome"] = _write(tmp / "genome.fa", _fa_text(recs))
    f["upper"] = _write(tmp / "upper.fa", _fa_text(
        [(n, s.upper().replace("N", "A")) for n, s in recs[:3]]
        + [("gappy", "ACGT--NNAC-T")]))
    f["all_n"] = _write(tmp / "all_n.fa", _fa_text([("x", "NNNN"),
                                                    ("y", "nnNN")]))
    dup = [recs[0], ("copy1", recs[2][1]), recs[2], ("copy2", recs[0][1]),
           recs[3], ("copy3", recs[0][1])]
    f["dups"] = _write(tmp / "dups.fa", _fa_text(dup))
    f["cg1"] = _write(tmp / "cg1.fa", _fa_text([("chr1", "CG" + "".join(
        rng.choice(list("ACGTacgtN"), 600, p=[.2, .2, .2, .2, .04, .04, .04,
                                              .04, .04])) + "CG")]))
    cg_aln = _alignment(rng, 700, 2)
    cg_aln = [(n, s.replace("A", "C", 40).replace("T", "G", 40))
              for n, s in cg_aln]
    f["cg2"] = _write(tmp / "cg2.fa", _fa_text(cg_aln))
    f["empty_rec"] = _write(tmp / "empty_rec.fa", ">e\n>f\nAC\n")
    # bed regions on the plain records and on the alignments' references
    f["genome_bed"] = _write(tmp / "genome.bed", "".join(
        f"{c}\t{s}\t{s + w}\tr{i}\n" for i, (c, s, w) in enumerate(
            [("chr1", 0, 100), ("chr1", 350, 300), ("chr2", 10, 50),
             ("chr4", 600, 700), ("chr3", 0, 77), ("chrN", 5, 10),
             ("chr2", 400, 20)])))
    f["missing_bed"] = _write(tmp / "missing.bed",
                              "chr1\t0\t10\nchrZ\t0\t10\n")
    n_ref = sum(c != "-" for c in aln2[0][1])
    f["aln_bed"] = _write(tmp / "aln.bed", "".join(
        f"chr1\t{s}\t{e}\tw{i}\n" for i, (s, e) in enumerate(
            [(0, 40), (35, 160), (200, 201), (300, n_ref - 1),
             (n_ref - 30, n_ref - 1)])))
    cg_ref = sum(c != "-" for c in cg_aln[0][1])
    f["cg_bed"] = _write(tmp / "cg.bed", "".join(
        f"chr1\t{s}\t{e}\tb{i}\n" for i, (s, e) in enumerate(
            [(0, 50), (60, 300), (320, 321), (400, cg_ref - 1)])))
    f["aln_bed_sorted"] = _write(tmp / "aln_sorted.bed", "".join(
        f"chr1\t{s}\t{e}\tv{i}\n" for i, (s, e) in enumerate(
            [(0, 40), (41, 160), (200, 201), (300, n_ref - 1)])))
    f["cg1_bed"] = _write(tmp / "cg1.bed", "chr1\t0\t100\tx\n"
                          "chr1\t90\t604\ty\nchr1\t300\t302\tz\n")
    f["cg_bed_far"] = _write(tmp / "far.bed", "chr1\t0\t9999\tfar\n")
    f["cg_bed_chr2"] = _write(tmp / "chr2.bed", "chr2\t0\t10\tc\n")
    f["cg_bed_noname"] = _write(tmp / "noname.bed", "chr1\t0\t10\n")
    f["append"] = _write(tmp / "append.fa", ">a\nTTTTnnGG\n")
    f["append2"] = _write(tmp / "append2.fa", ">a\nTT\n>b\nGG\n")
    # catMultiFa: the rows of aln3 cut into three files, and misfits
    cuts = (0, 130, 131, 520)
    for k in range(3):
        f[f"part{k}"] = _write(tmp / f"part{k}.fa", _fa_text(
            [(n, s[cuts[k]:cuts[k + 1]]) for n, s in aln3]))
    f["part_short"] = _write(tmp / "part_short.fa", _fa_text(aln3[:2]))
    f["part_renamed"] = _write(tmp / "part_renamed.fa", _fa_text(
        [aln3[0], ("seqZ", aln3[1][1]), aln3[2]]))
    f["list"] = _write(tmp / "list.txt", "".join(
        f[f"part{k}"] + "\n" for k in range(3)))
    return f


def _args(files, argv, d):
    return [files.get(a, a).format(d=d) for a in argv]


# case: (input, flags)
FIND_FAST_SHORT = {
    "w1": ("aln2", ["-windowSize", "1"]),
    "w10": ("aln2", ["-windowSize", "10", "-chrom", "chrX"]),
    "w37_remove_n": ("aln2", ["-windowSize", "37", "-removeN"]),
    "default_w1000_empty": ("aln2", []),
    "w100_3rows": ("aln3", ["-windowSize", "100", "-chrom", "c3"]),
    "named_queries": ("aln3", ["-windowSize", "25", "-firstQueryName",
                               "seqB", "-secondQueryName", "seqC"]),
    "named_queries_remove_n": ("aln3", ["-windowSize", "7", "-removeN",
                                        "-firstQueryName", "seqC",
                                        "-secondQueryName", "ref"]),
    "clean_w50": ("clean", ["-windowSize", "50", "-chrom", "chr9"]),
    # no gap in any row: the native scan's gap-free branch, its windows
    # across threads and its decimal carries (9, 99, 999 to the next)
    "gap_free_n_w1": ("gap_free_n", ["-windowSize", "1", "-chrom", "c"]),
    "gap_free_n_w50": ("gap_free_n", ["-windowSize", "50"]),
    "gap_free_n_w50_remove_n": ("gap_free_n", ["-windowSize", "50",
                                               "-removeN"]),
    "gap_free_n_one_window": ("gap_free_n", ["-windowSize", "1200",
                                             "-chrom", "chr1"]),
    "gap_free_w30_remove_n": ("gap_free", ["-windowSize", "30",
                                           "-removeN", "-chrom", "chr2"]),
}


@pytest.mark.parametrize("path", ["native_scan", "python_format"])
@pytest.mark.parametrize("case", list(FIND_FAST_SHORT))
def test_fa_find_fast_short_paths(files, tmp_path, monkeypatch, case, path):
    """faFindFast's short output equals the JAX tool's on each of the
    port's two paths: the native scan, and with the library off the
    numpy prefix sums formatted in Python."""
    src, flags = FIND_FAST_SHORT[case]
    scans = []
    if path == "native_scan":
        scan = native.fa_find_windows
        monkeypatch.setattr(native, "fa_find_windows",
                            lambda *a, **k: scans.append(scan(*a, **k))
                            or scans[-1])
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    got = _both(tmp_path, "faFindFast", lambda d: [
        files[src], f"{d}/o.bed", *flags])
    if path == "native_scan" and native.available():
        assert len(scans) == 1 and scans[0] is not None
    if case == "default_w1000_empty":
        assert got["o.bed"] == b""
    elif case == "gap_free_n_one_window":
        assert got["o.bed"].startswith(b"chr1\t0\t1200\tchr1_0\t")
    else:
        assert got["o.bed"].count(b"\n") > 3


FIND_FAST_LONG = {
    "long": ("aln2", ["-windowSize", "20", "-longOutput",
                      "-divergenceRate", "0.01"]),
    "long_rate_0_3": ("aln3", ["-windowSize", "40", "-longOutput",
                               "-divergenceRate", "0.3", "-chrom", "c"]),
    "long_aln_pos": ("aln2", ["-windowSize", "15", "-longOutput",
                              "-divergenceRate", "0.05", "-outputAlnPos"]),
    "long_remove_n": ("aln2", ["-windowSize", "30", "-longOutput",
                               "-divergenceRate", "0.1", "-removeN"]),
    "long_rate_0": ("aln2", ["-windowSize", "12", "-longOutput",
                             "-divergenceRate", "0"]),
    "long_rate_1": ("aln2", ["-windowSize", "12", "-longOutput",
                             "-divergenceRate", "1"]),
    "aln_pos": ("aln3", ["-windowSize", "9", "-outputAlnPos",
                         "-firstQueryName", "seqB"]),
    "aln_pos_remove_n": ("aln2", ["-windowSize", "9", "-outputAlnPos",
                                  "-removeN"]),
    "gc": ("clean", ["-windowSize", "30", "-gcContent", "-chrom", "g"]),
    "gc_with_n": ("aln3", ["-windowSize", "30", "-gcContent",
                           "-firstQueryName", "seqB"]),
    "rate_without_long": ("aln2", ["-windowSize", "30",
                                   "-divergenceRate", "0.5"]),
}


@pytest.mark.parametrize("case", list(FIND_FAST_LONG))
def test_fa_find_fast_long_formats(files, tmp_path, case):
    """-longOutput (p values from binomial_dist_cache_log10, as %e),
    -outputAlnPos, -gcContent and their pairs equal the JAX tool's;
    -gcContent on a first query with N exits as the JAX's does."""
    src, flags = FIND_FAST_LONG[case]
    got = _both(tmp_path, "faFindFast", lambda d: [
        files[src], f"{d}/o.bed", *flags])
    if case == "gc_with_n":
        assert "windowSize" in got
        return
    assert got["o.bed"].count(b"\n") > 3
    if case == "long":
        assert b"\t+\t" in got["o.bed"] and b"e-0" in got["o.bed"]


FIND_FAST_EXITS = {
    "one_record": ("one", [], "at least 2 fasta records"),
    "first_missing": ("aln3", ["-firstQueryName", "nope"],
                      "first query name is not found"),
    "second_missing": ("aln3", ["-secondQueryName", "nope"],
                       "second query name is not found"),
    "uneven": ("uneven", [], "not all of equal length"),
    "long_without_rate": ("aln2", ["-longOutput"], "divergenceRate"),
    "rate_out_of_range": ("aln2", ["-divergenceRate", "1.5"],
                          "between 0 and 1"),
    "gc_with_remove_n": ("clean", ["-gcContent", "-removeN"],
                         "cannot be used together"),
    "gc_with_aln_pos": ("clean", ["-gcContent", "-outputAlnPos"],
                        "cannot be used together"),
}


@pytest.mark.parametrize("case", list(FIND_FAST_EXITS))
def test_fa_find_fast_exits(files, tmp_path, case):
    """Each of faFindFast's error exits, with the JAX tool's message."""
    src, flags, word = FIND_FAST_EXITS[case]
    got = _both(tmp_path, "faFindFast", lambda d: [
        files[src], f"{d}/o.bed", *flags])
    assert word in got


FA_FILTER_CASES = {
    "default": ("genome", []),
    "name": ("genome", ["-name", "chr2"]),
    "not_name": ("genome", ["-notName", "chr2", "-minSize", "50"]),
    "name_contains": ("genome", ["-nameContains", "hr1"]),
    "min_size": ("genome", ["-minSize", "421"]),
    "gc_window": ("genome", ["-minGC", "45", "-maxGC", "55"]),
    "max_gc_low": ("genome", ["-maxGC", "10"]),
    "start_end": ("genome", ["-start", "30", "-end", "70"]),
    "start_only": ("genome", ["-start", "400"]),
    "end_before_start": ("genome", ["-start", "70", "-end", "30"]),
    "ref_positions": ("aln3", ["-refPositions", "-start", "20", "-end",
                               "300"]),
    "ref_positions_no_end": ("aln3", ["-refPositions", "-start", "20"]),
    "ref_positions_past_end": ("aln3", ["-refPositions", "-start", "20",
                                        "-end", "5000"]),
    "final_n_bases": ("genome", ["-finalNBases", "50"]),
    "final_n_bases_long": ("genome", ["-finalNBases", "1000"]),
    "cut_final_n_bases": ("genome", ["-cutFinalNBases", "80"]),
    "append_strings": ("genome", ["-appendBefore", "ACGTn",
                                  "-appendAfter", "ttt", "-name", "chr3"]),
    "append_fasta": ("genome", ["-appendBefore", "append", "-minSize",
                                "400"]),
    "append_fasta_two_records": ("genome", ["-appendAfter", "append2"]),
}


@pytest.mark.parametrize("case", list(FA_FILTER_CASES))
def test_fa_filter_byte_identical(files, tmp_path, case):
    """faFilter's FASTA, or its exit, equals the JAX tool's for each
    flag; -refPositions maps record 0's positions to columns."""
    src, flags = FA_FILTER_CASES[case]
    got = _both(tmp_path, "faFilter", lambda d: [
        files[src], f"{d}/o.fa", *_args(files, flags, d)])
    if case in ("end_before_start", "append_fasta_two_records",
                "ref_positions_no_end", "ref_positions_past_end"):
        assert isinstance(got, str)
    else:
        assert isinstance(got, dict)


GC_CONTENT_CASES = {
    "plain": ("genome_bed", "genome", []),
    "multi_fa": ("aln_bed", "aln2", ["-multiFaMode", "-multiFaSpecies",
                                     "seqB"]),
    "multi_fa_past_end": ("aln_bed", "aln3", ["-multiFaMode",
                                              "-multiFaSpecies", "seqC"]),
    "multi_fa_ref": ("aln_bed", "aln2", ["-multiFaMode",
                                         "-multiFaSpecies", "ref"]),
    "multi_fa_missing_species": ("aln_bed", "aln3", [
        "-multiFaMode", "-multiFaSpecies", "seqQ"]),
    "multi_fa_no_species": ("aln_bed", "aln3", ["-multiFaMode"]),
    "missing_chrom": ("missing_bed", "genome", []),
}


@pytest.mark.parametrize("case", list(GC_CONTENT_CASES))
def test_gc_content_byte_identical(files, tmp_path, case):
    """gcContent's bed, or its exit, equals the JAX tool's, on plain
    records and in -multiFaMode."""
    bed, fa, flags = GC_CONTENT_CASES[case]
    got = _both(tmp_path, "gcContent", lambda d: [
        files[bed], files[fa], f"{d}/o.bed", *flags])
    assert isinstance(got, str) == any(
        w in case for w in ("missing", "no_", "past"))


@pytest.mark.parametrize("src", ["upper", "genome", "dups"])
def test_fa_info_byte_identical(files, tmp_path, src):
    """faInfo's counts equal the JAX tool's; lower case exits as the
    JAX's does."""
    got = _both(tmp_path, "faInfo", lambda d: [files[src], "-outFile",
                                               f"{d}/info.txt"])
    if src == "upper":
        assert got["info.txt"].startswith(b"#Name\tA\tT\tC\tG\tGap\tN\n")
    else:
        assert "illegal character" in got


def test_fa_info_default_out_file(files, tmp_path, monkeypatch):
    """The default -outFile is a file named stdout in the working
    directory, as in the JAX tool."""
    got = _both(tmp_path, "faInfo", lambda d: [files["upper"]],
                chdir=monkeypatch.chdir)
    assert got["stdout"].startswith(b"#Name")


@pytest.mark.parametrize("src", ["dups", "genome", "aln3"])
def test_fa_uniq_byte_identical(files, tmp_path, src):
    """faUniq keeps the first record of each sequence and joins the
    names of its repeats, as the JAX tool does."""
    got = _both(tmp_path, "faUniq", lambda d: [files[src], f"{d}/u.fa"])
    if src == "dups":
        assert b">chr1; copy2; copy3\n" in got["u.fa"]


FA_BIN_CASES = {
    "bin1": ["-binNum", "1"], "bin2": ["-binNum", "2"],
    "bin3": ["-binNum", "3"], "bin6": ["-binNum", "6"],
    "too_many_bins": ["-binNum", "9"],
    "min_size_100": ["-minSize", "100"],
    "min_size_500": ["-minSize", "500"],
    "min_size_2000": ["-minSize", "2000", "-assembly", "asm"],
}


@pytest.mark.parametrize("case", list(FA_BIN_CASES))
def test_fa_bin_byte_identical(files, tmp_path, case):
    """faBin's files, named after their record or the assembly, or its
    exit, equal the JAX tool's for -binNum and -minSize."""
    got = _both(tmp_path, "faBin", lambda d: [files["genome"], d,
                                              *FA_BIN_CASES[case]])
    if case == "too_many_bins":
        assert "Reduce bin number" in got
    else:
        assert got and all(n.endswith(".fa") for n in got)


CAT_CASES = {
    "three": (["part0", "part1", "part2"], ["-o", "{d}/c.fa"]),
    "line_length": (["part0", "part2"], ["-o", "{d}/c.fa", "-lineLength",
                                         "17"]),
    "one": (["part1"], ["-o", "{d}/c.fa"]),
    "list": ([], ["-list", "list", "-o", "{d}/c.fa"]),
    "list_and_files": (["part0"], ["-list", "list", "-o", "{d}/c.fa"]),
    "none": ([], ["-o", "{d}/c.fa"]),
    "short": (["part0", "part_short"], ["-o", "{d}/c.fa"]),
    "renamed": (["part0", "part_renamed"], ["-o", "{d}/c.fa"]),
}


@pytest.mark.parametrize("case", list(CAT_CASES))
def test_cat_multi_fa_byte_identical(files, tmp_path, case):
    """catMultiFa's rows, or its exit, equal the JAX tool's; the three
    parts joined are the alignment they were cut from."""
    inputs, flags = CAT_CASES[case]
    got = _both(tmp_path, "catMultiFa", lambda d: [
        *(files[i] for i in inputs), *_args(files, flags, d)])
    if case in ("three", "list"):
        with open(files["aln3"], "rb") as f:
            want = f.read()
        assert got["c.fa"] == want  # both wrap at 50
    elif case in ("list_and_files", "none", "short", "renamed"):
        assert isinstance(got, str)


def test_cat_multi_fa_default_out(files, tmp_path, monkeypatch):
    """The default -o is a file named stdout, as in the JAX tool."""
    got = _both(tmp_path, "catMultiFa", lambda d: [files["part0"]],
                chdir=monkeypatch.chdir)
    assert got["stdout"].startswith(b">ref\n")


@pytest.mark.parametrize("src,flags", [
    ("genome", []), ("genome", ["-countLowerAsGaps"]), ("upper", []),
    ("aln3", ["-countLowerAsGaps"]), ("all_n", []),
    ("all_n", ["-countLowerAsGaps"])])
def test_assembly_stats_byte_identical(files, tmp_path, src, flags):
    """assemblyStats' N50, L50 and counts equal the JAX tool's, with and
    without lower case as gaps; an assembly of only N (n counted as a
    gap) exits alike."""
    got = _both(tmp_path, "assemblyStats", lambda d: [
        files[src], f"{d}/s.txt", *flags])
    if src == "all_n" and flags:
        assert "contig list is empty" in got
    else:
        assert got["s.txt"].startswith(b"Assembly Name: ")


LOCATE_CG_CASES = {
    "locate": ("cg1", []), "locate_on_aln_fails": ("cg2", []),
    "gain": ("cg2", ["-compare", "-cgtype", "gain"]),
    "loss": ("cg2", ["-compare", "-cgtype", "loss"]),
    "cons": ("cg2", ["-compare", "-cgtype", "cons"]),
    "no_type": ("cg2", ["-compare"]),
    "compare_three_rows": ("aln3", ["-compare", "-cgtype", "gain"]),
    "compare_uneven": ("uneven", ["-compare", "-cgtype", "cons"]),
    "compare_empty": ("empty_rec", ["-compare", "-cgtype", "cons"]),
}


@pytest.mark.parametrize("case", list(LOCATE_CG_CASES))
def test_locate_cg_byte_identical(files, tmp_path, case):
    """locateCG's sites, and in -compare mode the gained, lost and kept
    sites in reference coordinates, or its exit, equal the JAX tool's."""
    src, flags = LOCATE_CG_CASES[case]
    got = _both(tmp_path, "locateCG", lambda d: [
        files[src], "chr1", f"{d}/o", *flags])
    if case in ("locate", "gain", "loss", "cons"):
        assert got["o"].count(b"\n") > 2
    else:
        assert isinstance(got, str)


COUNT_PAIR_CASES = {
    "plain": ("cg1", ["C", "G"], []),
    "plain_ta": ("cg1", ["T", "A"], []),
    "bed": ("cg1", ["C", "G"], ["-bed", "cg1_bed"]),
    "bed_outside": ("cg1", ["C", "G"], ["-bed", "cg_bed_far"]),
    "bed_other_chrom": ("cg1", ["C", "G"], ["-bed", "cg_bed_chr2"]),
    "two_records": ("cg2", ["C", "G"], []),
    "compare": ("cg2", ["C", "G"], ["-compare"]),
    "compare_ag": ("aln2", ["A", "G"], ["-compare"]),
    "compare_bed": ("cg2", ["C", "G"], ["-compare", "-bed", "cg_bed"]),
    "compare_bed_aln": ("aln2", ["C", "A"], ["-compare", "-bed",
                                             "aln_bed_sorted"]),
    "compare_bed_overlapping": ("aln2", ["C", "A"], ["-compare", "-bed",
                                                     "aln_bed"]),
    "compare_bed_outside": ("cg2", ["C", "G"], ["-compare", "-bed",
                                                "cg_bed_far"]),
    "compare_bed_no_name": ("cg2", ["C", "G"], ["-compare", "-bed",
                                                "cg_bed_noname"]),
    "compare_bed_other_chrom": ("cg2", ["C", "G"], [
        "-compare", "-bed", "cg_bed_chr2"]),
    "compare_one_record": ("cg1", ["C", "G"], ["-compare"]),
    "two_bases": ("cg1", ["CG", "G"], []),
}


@pytest.mark.parametrize("case", list(COUNT_PAIR_CASES))
def test_count_pair_of_bases_byte_identical(files, tmp_path, case):
    """countPairOfBases' counts, over the sequence, its bed regions and
    in -compare mode over the alignment, or its exit, equal the JAX
    tool's."""
    src, bases, flags = COUNT_PAIR_CASES[case]
    got = _both(tmp_path, "countPairOfBases", lambda d: [
        files[src], "chr1", *bases, f"{d}/o", *_args(files, flags, d)])
    if case in ("plain", "plain_ta", "bed", "compare", "compare_ag",
                "compare_bed", "compare_bed_aln"):
        assert got["o"].count(b"\n") >= 2
    else:
        assert isinstance(got, str)


def _bits(values) -> bytes:
    return np.array(values, np.float64).tobytes()


@pytest.mark.parametrize("n,p", [(1, 0.5), (10, 0.01), (37, 0.5),
                                 (100, 0.2), (1000, 0.01), (250, 0.0),
                                 (250, 1.0), (64, 0.999)])
def test_binomial_dist_cache_log10_bit_for_bit(n, p):
    """binomial_dist_cache_log10 and the binomial helpers under it equal
    the JAX's bit for bit."""
    got = numbers.binomial_dist_cache_log10(n, p)
    want = jnumbers.binomial_dist_cache_log10(n, p)
    assert list(got) == list(want) == list(range(n, -1, -1))
    assert _bits(list(got.values())) == _bits(list(want.values()))
    ks = range(0, n + 1, max(1, n // 17))
    for fn in ("binom_coefficient_log", "binomial_dist_log"):
        args = [(n, k) if fn == "binom_coefficient_log" else (n, k, p)
                for k in ks]
        assert _bits([getattr(numbers, fn)(*a) for a in args]) == _bits(
            [getattr(jnumbers, fn)(*a) for a in args])
    assert _bits([numbers.binomial_expression_log(n, k, p) for k in ks]) \
        == _bits([jnumbers.binomial_expression_log(n, k, p) for k in ks])


def test_numbers_errors_and_fisher_unchanged():
    """The package's errors are the JAX's, and fisher_exact is where the
    variant caller imports it, with the JAX's values."""
    for mod in (numbers, jnumbers):
        with pytest.raises(ValueError, match="between 0 and 1"):
            mod.binomial_dist_cache_log10(10, 1.5)
        with pytest.raises(ValueError, match="bad binomial"):
            mod.binom_coefficient_log(3, 5)
    from gonomics_tpu_torch.cli import call_variants
    assert call_variants.fisher_exact is numbers.fisher_exact
    tables = [(3, 17, 20, 1), (0, 0, 5, 9), (40, 2, 1, 39), (7, 7, 7, 7)]
    for t in tables:
        for small in (True, False):
            assert _bits([numbers.fisher_exact(*t, small)]) == _bits(
                [jnumbers.fisher_exact(*t, small)])


def test_logspace_bit_for_bit():
    """Every logspace function equals the JAX's bit for bit on a grid
    that holds -inf, 0, the guard thresholds and both orders, and raises
    what the JAX's raises."""
    inf = float("inf")
    grid = [-inf, -800.0, -745.0, -3.5, -1e-9, 0.0, 1e-300, 0.25, 2.0,
            700.0, 709.5, 1e6]
    assert _bits([logspace.go_log(x) for x in grid]) == _bits(
        [jlogspace.go_log(x) for x in grid])
    assert [logspace.can_convert(x) for x in grid] == [
        jlogspace.can_convert(x) for x in grid]
    assert _bits([logspace.to_base10(x) for x in grid]) == _bits(
        [jlogspace.to_base10(x) for x in grid])
    for fn in ("add", "subtract", "multiply", "divide", "pow_"):
        for x in grid:
            for y in grid:
                res = []
                for mod in (logspace, jlogspace):
                    try:
                        res.append(_bits([getattr(mod, fn)(x, y)]))
                    except (ValueError, ZeroDivisionError) as e:
                        res.append(f"{type(e).__name__}: {e}")
                assert res[0] == res[1], (fn, x, y)
    assert logspace.NEG_INF == jlogspace.NEG_INF


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int64])
def test_define_base_mask_equals_the_jax(dtype):
    """dna.define_base_mask, the one DefineBase that faFormat, faFindFast,
    locateCG and countPairOfBases share, equals the JAX's on every code,
    on an array and on a single code."""
    codes = np.arange(dna.NUM_BASES, dtype=dtype)
    got = dna.define_base_mask(codes)
    assert got.tolist() == jdna.define_base_mask(codes).tolist()
    assert got.tolist() == [c in "ACGTacgt" for c in "ACGTNacgtn-.*"]
    assert [bool(dna.define_base_mask(int(c))) for c in codes] == \
        got.tolist()


def test_fasta_additions_equal_the_jax(files, tmp_path):
    """to_map, ref_pos_to_aln_pos(_counter), make_contig_list,
    calculate_n50_l50, assembly_stats and bin_genome_no_breaks against
    the JAX's, their errors too."""
    recs, jrecs = fasta.read(files["aln3"]), jfasta.read(files["aln3"])
    m, jm = fasta.to_map(recs), jfasta.to_map(jrecs)
    assert list(m) == list(jm)
    assert all(np.array_equal(m[k], jm[k]) for k in m)
    dup = [recs[0], fasta.Fasta(recs[0].name, recs[1].seq)]
    jdup = [jrecs[0], jfasta.Fasta(jrecs[0].name, jrecs[1].seq)]
    for mod, arg in ((fasta, dup), (jfasta, jdup)):
        with pytest.raises(ValueError, match="multiple fasta records"):
            mod.to_map(arg)

    def outcome(fn, *args):
        try:
            return fn(*args)
        except (ValueError, IndexError) as e:
            return f"{type(e).__name__}: {e}"

    n_ref = int((recs[0].seq != 10).sum())
    for pos in [0, 1, 2, 17, 100, n_ref - 1, n_ref, n_ref + 3]:
        for rec, jrec in zip(recs, jrecs):
            assert outcome(fasta.ref_pos_to_aln_pos, rec, pos) == outcome(
                jfasta.ref_pos_to_aln_pos, jrec, pos)
            for start, aln in ((0, 0), (5, 9), (pos, 40), (pos + 1, 3)):
                assert outcome(fasta.ref_pos_to_aln_pos_counter, rec, pos,
                               start, aln) == outcome(
                    jfasta.ref_pos_to_aln_pos_counter, jrec, pos, start,
                    aln)
    genome, jgenome = fasta.read(files["genome"]), jfasta.read(
        files["genome"])
    for lower in (False, True):
        contigs = fasta.make_contig_list(genome, lower)
        assert contigs == jfasta.make_contig_list(jgenome, lower)
        contigs.sort()
        for half in (0, sum(contigs) // 2, sum(contigs), sum(contigs) + 1):
            assert outcome(fasta.calculate_n50_l50, contigs, half) == \
                outcome(jfasta.calculate_n50_l50, contigs, half)
        assert fasta.assembly_stats(files["genome"], lower) == \
            jfasta.assembly_stats(files["genome"], lower)
    for bin_num, min_size in ((1, -1), (2, -1), (4, -1), (6, -1), (1, 0),
                              (1, 50), (3, 800), (1, 5000)):
        got = fasta.bin_genome_no_breaks(genome, bin_num, min_size)
        want = jfasta.bin_genome_no_breaks(jgenome, bin_num, min_size)
        assert {k: [r.name for r in v] for k, v in got.items()} == {
            k: [r.name for r in v] for k, v in want.items()}
    for mod, g in ((fasta, genome), (jfasta, jgenome)):
        with pytest.raises(SystemExit, match="Reduce bin number"):
            mod.bin_genome_no_breaks(g, 7, -1)
