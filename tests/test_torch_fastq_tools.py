"""The port's FASTQ tools of slice 11.7a (``fastqFilter``, ``fastqFormat``,
``fastqReplaceSeq``, ``longReadLibStats``; gonomics_tpu_torch/cli/) and
FASTQ's pair I/O and ``fileio.go_v`` under them, on the CPU against the
JAX package: the bytes of every file the tools write and the message of
every exit, on reads that a numpy seed builds here: lengths from 8 to
90, N and lower-case bases, names with a comment after a space, mates
whose names differ, barcodes and UMIs drawn from small sets so that
cells and UMIs repeat. Each quirk of the reference that the port keeps
is pinned by a case here.
"""

import os

import numpy as np
import pytest

from gonomics_tpu import fileio as jfileio
from gonomics_tpu.cli import fastq_filter as jfastq_filter
from gonomics_tpu.cli import fastq_format as jfastq_format
from gonomics_tpu.cli import fastq_replace_seq as jfastq_replace_seq
from gonomics_tpu.cli import long_read_lib_stats as jlong_read_lib_stats
from gonomics_tpu.io import fastq as jfastq
from gonomics_tpu_torch import dna, fileio
from gonomics_tpu_torch.cli import fastq_filter, fastq_format
from gonomics_tpu_torch.cli import fastq_replace_seq, long_read_lib_stats
from gonomics_tpu_torch.io import fastq

TOOLS = {"fastqFilter": (jfastq_filter.main, fastq_filter.main),
         "fastqFormat": (jfastq_format.main, fastq_format.main),
         "fastqReplaceSeq": (jfastq_replace_seq.main, fastq_replace_seq.main),
         "longReadLibStats": (jlong_read_lib_stats.main,
                              long_read_lib_stats.main)}


def _both(tmp_path, tool: str, argv) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits and the files they wrote
    equal; returns the port's {name: bytes} with its exit message under
    "exit" where it exited (fastqReplaceSeq exits after writing), or the
    type and message of any other exception."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        out = {}
        try:
            main(argv(str(d)))
        except SystemExit as e:
            out["exit"] = str(e)
        except Exception as e:  # the JAX tools' ValueError, ...
            out["exit"] = f"{type(e).__name__}: {e}"
        for n in sorted(os.listdir(d)):
            with open(os.path.join(d, n), "rb") as f:
                out[n] = f.read()
        seen[side] = out
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _fastq_lines(rng, names, lengths, barcodes=None, umis=None) -> str:
    out = []
    for i, (name, n) in enumerate(zip(names, lengths)):
        seq = "".join(rng.choice(list("ACGTNacgt"), n,
                                 p=[.22, .22, .22, .22, .04, .02, .02, .02,
                                    .02]))
        if barcodes is not None:
            seq = barcodes[i] + umis[i] + seq
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41,
                                                               len(seq)))
        out.append(f"@{name}\n{seq}\n+\n{qual}\n")
    return "".join(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fastq_tools")
    rng = np.random.default_rng(2612)
    n = 120
    f = {k: str(d / k) for k in ("in.fq", "r1.fq", "r2.fq", "short.fq",
                                  "retain.txt", "discard.txt", "cells.txt",
                                  "table.tsv", "table.csv", "long.fq",
                                  "lower.tsv", "none.tsv", "big.tsv",
                                  "three.tsv", "uneven.tsv")}
    names = [f"r{i}" + (f" comment{i}" if i % 4 == 0 else "")
             for i in range(n)]
    lengths = rng.integers(8, 91, n).tolist()
    with open(f["in.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, names, lengths))
    cells = ["".join(rng.choice(list("ACGT"), 6)) for _ in range(5)]
    umis = ["".join(rng.choice(list("ACGT"), 3)) for _ in range(4)]
    bx = [cells[int(i)] for i in rng.integers(0, 5, n)]
    ux = [umis[int(i)] for i in rng.integers(0, 4, n)]
    with open(f["r1.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, [f"p{i} 1:N" for i in range(n)],
                              rng.integers(8, 60, n).tolist(), bx, ux))
    with open(f["r2.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, [f"m{i} 2:N" for i in range(n)],
                              rng.integers(8, 90, n).tolist()))
    with open(f["short.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, ["s0", "s1"], [30, 40]))
    with open(f["retain.txt"], "w") as fh:
        fh.write("".join(f"{x}\n" for x in ("r1", "r4 comment4", "r7", "p3",
                                            "m5", "p9", "m9", "#r2")))
    with open(f["discard.txt"], "w") as fh:
        fh.write("r3\nr10\np2\nm4\n")
    with open(f["cells.txt"], "w") as fh:
        fh.write(f"{cells[0]}\n{cells[3]}\n")
    # prefixes of some reads, the first pair matching wherever the second
    # does, and a lower-case copy that ignoreCase matches
    seqs = [fq.seq for fq in fastq.read(f["in.fq"])]
    heads = [dna.to_string(dna.to_upper(s[:5])) for s in seqs[:40:3]]
    pairs = [(h, h[::-1]) for h in heads]
    pairs.insert(1, (heads[2][:3], "TTT"))
    with open(f["table.tsv"], "w") as fh:
        fh.writelines(f"{a}\t{b}\n" for a, b in pairs)
    with open(f["table.csv"], "w") as fh:
        fh.writelines(f"{a},{b}\n" for a, b in pairs)
    with open(f["lower.tsv"], "w") as fh:
        fh.writelines(f"{a.lower()}\t{b}\n" for a, b in pairs)
    with open(f["none.tsv"], "w") as fh:
        fh.write("NNNNNNN\tAAAAAAA\n")
    with open(f["big.tsv"], "w") as fh:
        fh.write("A" * 12 + "\t" + "C" * 12 + "\n")
    with open(f["three.tsv"], "w") as fh:
        fh.write("ACG\tTTT\tGGG\n")
    with open(f["uneven.tsv"], "w") as fh:
        fh.write("ACG\tTT\n")
    f["tie.fq"] = str(d / "tie.fq")
    with open(f["tie.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, ["a", "b", "c"], [20, 10, 10]))
    with open(f["long.fq"], "w") as fh:
        fh.write(_fastq_lines(rng, [f"l{i}" for i in range(60)],
                              rng.integers(200, 5000, 60).tolist()))
    return f


@pytest.mark.parametrize("args", [
    [], ["-minSize", "30", "-maxSize", "70"],
    ["-subSet", "0.5", "-setSeed", "7"],
    ["-subSet", "0.5", "-setSeed", "7", "-minSize", "50"],
    ["-subSet", "1", "-setSeed", "3", "-minSize", "40"],
    ["-retainNamesList", "retain.txt"],
    ["-discardNamesList", "discard.txt", "-subSet", "0.8", "-setSeed", "1"]])
def test_fastq_filter_single(files, tmp_path, args):
    """Single-end: every record draws, before the size test, so a seeded
    subset with -minSize keeps what the JAX's does; names are matched
    whole, comment and all."""
    d = os.path.dirname(files["in.fq"])
    args = [os.path.join(d, a) if a.endswith(".txt") else a for a in args]
    got = _both(tmp_path, "fastqFilter", lambda o: [
        files["in.fq"], os.path.join(o, "out.fq"), *args])
    assert "exit" not in got
    if args[:1] == ["-retainNamesList"]:
        kept = got["out.fq"].decode().splitlines()[::4]
        assert kept == ["@r1", "@r4 comment4", "@r7"]


@pytest.mark.parametrize("args", [
    [], ["-minSize", "20", "-maxSize", "70"],
    ["-subSet", "0.5", "-setSeed", "7", "-minSize", "20"],
    ["-retainNamesList", "retain.txt"],
    ["-discardNamesList", "discard.txt"],
    ["-collapseUmi", "-barcodeLength", "6", "-umiLength", "3"],
    ["-keepCellsList", "cells.txt", "-barcodeLength", "6", "-umiLength", "3"],
    ["-collapseUmi", "-keepCellsList", "cells.txt", "-barcodeLength", "6",
     "-umiLength", "3", "-subSet", "0.9", "-setSeed", "5"]])
def test_fastq_filter_paired(files, tmp_path, args):
    """Paired-end: a pair draws only where -subSet < 1, after the size
    test; names are cut at the first space, and -retainNamesList keeps a
    pair if either mate's name is listed; -collapseUmi keys on the
    (barcode, UMI) bytes."""
    d = os.path.dirname(files["in.fq"])
    args = [os.path.join(d, a) if a.endswith(".txt") else a for a in args]
    got = _both(tmp_path, "fastqFilter", lambda o: [
        "-pairedEnd", files["r1.fq"], files["r2.fq"],
        os.path.join(o, "o1.fq"), os.path.join(o, "o2.fq"), *args])
    assert "exit" not in got
    names = got["o1.fq"].decode().splitlines()[::4]
    if args[:1] == ["-retainNamesList"]:
        assert names == ["@p3", "@p5", "@p9"]
    if args[:1] == ["-collapseUmi"] and len(args) == 5:
        assert 0 < len(names) <= 20


@pytest.mark.parametrize("args,want", [
    (["-retainNamesList", "x", "-discardNamesList", "y"],
     "fastqFilter cannot accept arguments for both a discard names list and "
     "retain names list simultaneously."),
    (["-subSet", "1.5"], "The subSet option must be between 0 and 1, "
     "received 1.5."),
    (["-collapseUmi"], "To collapse UMIs from single-cell reads, select "
     "pairedEnd AND collapseUmi."),
    (["-keepCellsList", "x"],
     "keepCellsList must be used in paired end mode")])
def test_fastq_filter_exits(files, tmp_path, args, want):
    got = _both(tmp_path, "fastqFilter", lambda o: [
        files["in.fq"], os.path.join(o, "out.fq"), *args])
    assert got["exit"] == want


def test_fastq_filter_uneven_pairs_raise(files, tmp_path):
    """read_pairs raises ValueError where the files differ in count."""
    got = _both(tmp_path, "fastqFilter", lambda o: [
        "-pairedEnd", files["r1.fq"], files["short.fq"],
        os.path.join(o, "o1.fq"), os.path.join(o, "o2.fq")])
    assert got["exit"].startswith("ValueError")


@pytest.mark.parametrize("args", [[], ["-barcodeLength", "6",
                                       "-umiLength", "3"]])
def test_fastq_format(files, tmp_path, args):
    """Both mates renamed _UMI:<umi>_BX:<barcode>, the forward read
    trimmed of both."""
    got = _both(tmp_path, "fastqFormat", lambda o: [
        "-pairedEnd", "-singleCell", files["r1.fq"], files["r2.fq"],
        os.path.join(o, "o1.fq"), os.path.join(o, "o2.fq"), *args])
    first = got["o1.fq"].decode().splitlines()
    assert "_UMI:" in first[0] and "_BX:" in first[0]
    if args:
        src = open(files["r1.fq"]).read().splitlines()
        assert first[1] == src[1][9:]
        assert first[0] == f"@p0_UMI:{src[1][6:9]}_BX:{src[1][:6]}"


@pytest.mark.parametrize("flags", [["-singleCell"], ["-pairedEnd"]])
def test_fastq_format_exits(files, tmp_path, flags):
    got = _both(tmp_path, "fastqFormat", lambda o: [
        *flags, files["r1.fq"], files["r2.fq"], os.path.join(o, "o1.fq"),
        os.path.join(o, "o2.fq")])
    assert got["exit"].startswith("fastqFormat is still under development")


@pytest.mark.parametrize("table,args", [
    ("table.tsv", []), ("table.tsv", ["-replacedRecordsOnly"]),
    ("table.csv", ["-replaceDelim", ","]), ("lower.tsv", ["-ignoreCase"]),
    ("none.tsv", []), ("big.tsv", []), ("three.tsv", []),
    ("uneven.tsv", [])])
def test_fastq_replace_seq(files, tmp_path, table, args):
    """Prefixes only, the first matching pair winning, case ignored (the
    flag cannot be turned off); a find longer than a read exits, and a run
    that replaced nothing exits after writing its output."""
    d = os.path.dirname(files["in.fq"])
    got = _both(tmp_path, "fastqReplaceSeq", lambda o: [
        files["in.fq"], os.path.join(d, table), os.path.join(o, "out.fq"),
        *args])
    if table == "none.tsv":
        assert got["exit"] == "Error: No pattern(s) found in input file."
        assert got["out.fq"].count(b"\n") == 4 * 120
    elif table == "big.tsv":
        assert got["exit"].startswith("Error: Length of find sequence")
    elif table in ("three.tsv", "uneven.tsv"):
        assert got["exit"].startswith("Error:")
    else:
        assert "exit" not in got


@pytest.mark.parametrize("src,lengths", [("long.fq", False),
                                         ("long.fq", True), ("tie.fq", True)])
def test_long_read_lib_stats(files, tmp_path, src, lengths):
    """The count, and the N50 of the lengths sorted descending at half the
    total: calculate_n50_l50 walks that list from its end, the shortest
    read, so where the sum lands on half the total exactly (10, 10, 20)
    it is the shorter read's length. Each length in input order."""
    got = _both(tmp_path, "longReadLibStats", lambda o: [
        files[src], os.path.join(o, "stats.txt"),
        *(["-readLengths", os.path.join(o, "lens.txt")] if lengths else [])])
    lens = [len(fq.seq) for fq in fastq.read(files[src])]
    if lengths:
        assert got["lens.txt"].decode().split() == [str(n) for n in lens]
    tot, acc = sum(lens), 0
    for n in sorted(lens):
        acc += n
        if acc >= tot // 2:
            break
    assert got["stats.txt"] == \
        f"Total number of reads: {len(lens)}\nN50: {n}\n".encode()
    if src == "tie.fq":
        assert n == 10


def _fq_key(fq):
    return (fq.name, fq.seq.tobytes(), np.asarray(fq.qual).tobytes())


def test_pair_io_equals_jax(files, tmp_path):
    """read_pairs, to_single_cell_pair, write_pairs and write_to_handle
    against the JAX's."""
    want = jfastq.read_pairs(files["r1.fq"], files["r2.fq"])
    got = fastq.read_pairs(files["r1.fq"], files["r2.fq"])
    assert [(_fq_key(a), _fq_key(b)) for a, b in got] == \
        [(_fq_key(a), _fq_key(b)) for a, b in want]
    for (a, b), (ja, jb) in zip(got, want):
        for bl, ul in ((16, 12), (6, 3), (0, 0), (200, 5)):
            g = fastq.to_single_cell_pair(a, b, bl, ul)
            w = jfastq.to_single_cell_pair(ja, jb, bl, ul)
            assert [_fq_key(x) for x in g[:2]] == [_fq_key(x) for x in w[:2]]
            assert [x.tobytes() for x in g[2:]] == [x.tobytes() for x in w[2:]]
    fastq.write_pairs(str(tmp_path / "a1"), str(tmp_path / "a2"), got)
    jfastq.write_pairs(str(tmp_path / "b1"), str(tmp_path / "b2"), want)
    for x, y in (("a1", "b1"), ("a2", "b2")):
        assert (tmp_path / x).read_bytes() == (tmp_path / y).read_bytes()
    with open(tmp_path / "h", "w") as fh:
        fastq.write_to_handle(fh, got[0][0])
    assert (tmp_path / "h").read_text() == \
        "".join((tmp_path / "b1").read_text().splitlines(True)[:4])
    with pytest.raises(ValueError, match="different read counts"):
        fastq.read_pairs(files["r1.fq"], files["short.fq"])


def test_go_v_equals_jax():
    rng = np.random.default_rng(9)
    values = [0.0, -0.0, 1.0, 2.5, 1e21, 1e-7, 123456789.0, 1 / 3,
              float("inf"), float("-inf"), float("nan")]
    values += (rng.random(50) * 10.0 ** rng.integers(-8, 12, 50)).tolist()
    assert [fileio.go_v(v) for v in values] == \
        [jfileio.go_v(v) for v in values]
