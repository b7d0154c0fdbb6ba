"""The port's multiFa tools of slice 11.6 (``multiFaCount``,
``multiFaScan``, ``multiFaExtract``, ``multiFaReduce``, ``mergeMultiFa``,
``multiFaSequenceSwap``, ``multiFaToChain``; gonomics_tpu_torch/cli/) on
the CPU against the JAX tools: the bytes of every file they write and
the message of every exit, on alignments that a numpy seed builds here
(rows with gap runs, columns that are gaps in every row, upper- and
lower-case N, lower-case bases, substitutions). Each quirk of the
reference that the port keeps is pinned by a case here. Also the library
under them: ``io/fasta.py``'s multiFa helpers and ``io/formats.py``'s
``chain_to_string`` and ``write_chain`` against the JAX's.
"""

import os

import numpy as np
import pytest

from gonomics_tpu.cli import merge_multi_fa as jmerge
from gonomics_tpu.cli import multi_fa_count as jcount
from gonomics_tpu.cli import multi_fa_extract as jextract
from gonomics_tpu.cli import multi_fa_reduce as jreduce
from gonomics_tpu.cli import multi_fa_scan as jscan
from gonomics_tpu.cli import multi_fa_sequence_swap as jswap
from gonomics_tpu.cli import multi_fa_to_chain as jto_chain
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import formats as jformats
from gonomics_tpu_torch.cli import merge_multi_fa, multi_fa_count
from gonomics_tpu_torch.cli import multi_fa_extract, multi_fa_reduce
from gonomics_tpu_torch.cli import multi_fa_scan, multi_fa_sequence_swap
from gonomics_tpu_torch.cli import multi_fa_to_chain
from gonomics_tpu_torch.io import fasta, formats

TOOLS = {"multiFaCount": (jcount.main, multi_fa_count.main),
         "multiFaScan": (jscan.main, multi_fa_scan.main),
         "multiFaExtract": (jextract.main, multi_fa_extract.main),
         "multiFaReduce": (jreduce.main, multi_fa_reduce.main),
         "mergeMultiFa": (jmerge.main, merge_multi_fa.main),
         "multiFaSequenceSwap": (jswap.main, multi_fa_sequence_swap.main),
         "multiFaToChain": (jto_chain.main, multi_fa_to_chain.main)}


def _both(tmp_path, monkeypatch, tool: str, argv) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), each from a
    directory d of its own (the working directory too), and holds their
    exits and the files they wrote equal; returns the port's {file name:
    bytes}, or its exit: the SystemExit's message, or the type and
    message of any other exception."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
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


def _write_fa(path, records, width=60) -> str:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            f.writelines(seq[i:i + width] + "\n"
                         for i in range(0, len(seq), width))
    return str(path)


def _mutate(rng, row: np.ndarray, rate: float) -> np.ndarray:
    out = row.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(hit.sum()))
    return out


def _gap_runs(rng, row: np.ndarray, runs: int) -> np.ndarray:
    out = row.copy()
    for _ in range(runs):
        a = int(rng.integers(0, len(out) - 12))
        out[a:a + int(rng.integers(1, 12))] = ord("-")
    return out


def _alignment(rng, names, n_cols: int, marks: bool = True):
    """Rows of n_cols columns: a random first row and mutants of it, gap
    runs in every row, some all-gap columns, and (with marks) N, n and
    lower-case bases."""
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), n_cols)
    rows = [ref] + [_mutate(rng, ref, 0.06) for _ in names[1:]]
    rows = [_gap_runs(rng, r, 6) for r in rows]
    both = rng.choice(n_cols, 8, replace=False)
    for r in rows:
        r[both] = ord("-")
        if marks:
            for ch, rate in ((b"N", 0.02), (b"n", 0.01)):
                hit = (rng.random(n_cols) < rate) & (r != ord("-"))
                r[hit] = ch[0]
            low = (rng.random(n_cols) < 0.03) & np.isin(
                r, np.frombuffer(b"ACGT", np.uint8))
            r[low] += 32
    return [(n, r.tobytes().decode()) for n, r in zip(names, rows)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_fa_tools")
    rng = np.random.default_rng(2600)
    f = {}
    aln = _alignment(rng, ["hg38", "panTro6", "gorGor5", "ponAbe3"], 700)
    f["aln"] = _write_fa(tmp / "aln.fa", aln)
    f["rows"] = dict(aln)
    f["pair"] = _write_fa(tmp / "pair.fa", aln[:2])
    f["pair_clean"] = _write_fa(tmp / "pair_clean.fa", _alignment(
        rng, ["t", "q"], 400, marks=False))
    f["short"] = _write_fa(tmp / "short.fa", [aln[0], (aln[1][0],
                                                       aln[1][1][:-5])])
    f["dot"] = _write_fa(tmp / "dot.fa", [aln[0], (aln[1][0], "."
                                                   + aln[1][1][1:])])
    f["dot_t"] = _write_fa(tmp / "dot_t.fa", [(aln[0][0], "."
                                               + aln[0][1][1:]), aln[1]])
    f["hand"] = _write_fa(tmp / "hand.fa", [("t", "ACGT--ACGT"),
                                            ("q", "ACGTAAAC-T")])
    # mergeMultiFa: one ungapped reference, gapped two ways, with rows
    # of each file's own; b's reference ends early, a's with gaps
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 500)

    def gapped(row, cols):
        return np.insert(row, np.sort(cols), ord("-"))

    ga = rng.choice(500, 30)
    gb = rng.choice(500, 25)
    a_ref = np.concatenate([gapped(ref, ga), np.frombuffer(b"---", np.uint8)])
    b_ref = gapped(ref, gb)[:-7]
    a_rows = [("hg38", a_ref)] + [
        (n, _gap_runs(rng, _mutate(rng, a_ref, 0.05), 3))
        for n in ("panTro6", "gorGor5")]
    b_rows = [("hg38", b_ref)] + [
        (n, _gap_runs(rng, _mutate(rng, b_ref, 0.05), 3))
        for n in ("mm10", "rn7")]
    for k, rows in (("merge_a", a_rows), ("merge_b", b_rows)):
        f[k] = _write_fa(tmp / f"{k}.fa",
                         [(n, r.tobytes().decode()) for n, r in rows])
    f["merge_a_len"] = len(a_ref)
    f["merge_b_len"] = len(b_ref)
    low = b_ref.copy()
    low[np.flatnonzero(low != ord("-"))[40]] += 32
    f["merge_b_lower"] = _write_fa(tmp / "merge_b_lower.fa", [
        ("hg38", low.tobytes().decode())] + [
        (n, r.tobytes().decode()) for n, r in b_rows[1:]])
    f["merge_b_name"] = _write_fa(tmp / "merge_b_name.fa", [
        ("mm39", b_ref.tobytes().decode()), ("rn7", b_ref.tobytes().decode())])
    f["merge_one"] = _write_fa(tmp / "merge_one.fa", [
        ("hg38", b_ref.tobytes().decode())])
    f["merge_uneven"] = _write_fa(tmp / "merge_uneven.fa", [
        ("hg38", b_ref.tobytes().decode()),
        ("rn7", b_ref.tobytes().decode()[:-1])])
    # regions: unsorted, overlapping, adjacent, and on another chrom
    with open(tmp / "regions.bed", "w") as fh:
        fh.write("chr1\t300\t320\nchr1\t10\t40\nchr2\t5\t50\n"
                 "chr1\t35\t60\nchr1\t60\t61\nchr1\t500\t530\n")
    f["regions"] = str(tmp / "regions.bed")
    with open(tmp / "bad_region.bed", "w") as fh:
        fh.write("chr1\t10\t20\nchr1\t50\t50\n")
    f["bad_region"] = str(tmp / "bad_region.bed")
    with open(tmp / "extract.bed", "w") as fh:
        fh.write("chr1\t0\t30\nchr9\t100\t180\nchr1\t400\t560\n")
    f["extract_bed"] = str(tmp / "extract.bed")
    return f


def _present(row: str) -> np.ndarray:
    return np.isin(np.frombuffer(row.encode(), np.uint8),
                   np.frombuffer(b"ACGT", np.uint8))


@pytest.mark.parametrize("args", [
    ["hg38"], ["gorGor5"],
    ["panTro6", "-both", "-secondQueryName", "ponAbe3"],
    ["hg38", "-either", "-secondQueryName", "panTro6", "-thirdQueryName",
     "gorGor5"]])
def test_multi_fa_count(files, tmp_path, monkeypatch, args):
    got = _both(tmp_path, monkeypatch, "multiFaCount",
                lambda d: [args[0], files["aln"], f"{d}/out.txt", *args[1:]])
    # present: upper-case A, C, G or T only
    rows = files["rows"]
    names = [args[0]] + [a for a in args[1:] if a in rows]
    present = [_present(rows[n]) for n in names]
    want = (present[0].sum() if len(names) == 1 else
            np.logical_and.reduce(present).sum() if "-both" in args else
            np.logical_or.reduce(present).sum())
    assert got["out.txt"].decode().splitlines()[1].split("\t")[-1] == \
        str(int(want))


@pytest.mark.parametrize("args,want", [
    (["hg38", "-both", "-either"], "mutually exclusive"),
    (["mm10"], "queryName mm10 not found in fasta records."),
    (["hg38", "-both"], "queryName  not found in fasta records."),
])
def test_multi_fa_count_exits(files, tmp_path, monkeypatch, args, want):
    got = _both(tmp_path, monkeypatch, "multiFaCount",
                lambda d: [args[0], files["aln"], f"{d}/out.txt", *args[1:]])
    assert want in got


@pytest.mark.parametrize("query,chrom", [("panTro6", []),
                                         ("ponAbe3", ["--chrom", "chr7"]),
                                         ("hg38", [])])
def test_multi_fa_scan(files, tmp_path, monkeypatch, query, chrom):
    got = _both(tmp_path, monkeypatch, "multiFaScan", lambda d: [
        "--queryName", query, *chrom, files["aln"], f"{d}/out.bed"])
    lines = got["out.bed"].decode().splitlines()
    rows = files["rows"]
    n_cols = np.flatnonzero(np.frombuffer(rows[query].encode(), np.uint8)
                            == ord("N"))
    # upper-case N only, at the first record's positions, named after it
    assert len(lines) == len(n_cols) > 0
    ref = np.frombuffer(rows["hg38"].encode(), np.uint8) != ord("-")
    assert [ln.split("\t") for ln in lines] == [
        [chrom[1] if chrom else "chrom", str(int(ref[:c].sum())),
         str(int(ref[:c].sum()) + 1), "hg38"] for c in n_cols]


def test_multi_fa_scan_empty_query_exits(files, tmp_path, monkeypatch):
    got = _both(tmp_path, monkeypatch, "multiFaScan",
                lambda d: [files["aln"], f"{d}/out.bed"])
    assert got == "queryName  not found in fasta records."


@pytest.mark.parametrize("args", [["0", "100"], ["37", "390"],
                                  ["37", "390", "-removeGaps"],
                                  ["600", "601"]])
def test_multi_fa_extract(files, tmp_path, monkeypatch, args):
    got = _both(tmp_path, monkeypatch, "multiFaExtract",
                lambda d: [files["aln"], f"{d}/out.fa", *args])
    assert got["out.fa"].count(b">") == 4


@pytest.mark.parametrize("gaps", [[], ["-removeGaps"]])
def test_multi_fa_extract_bed_writes_to_cwd(files, tmp_path, monkeypatch,
                                            gaps):
    """With -bed each region goes to chrom.start.end.fa in the working
    directory: the CLI never sets out_dir."""
    got = _both(tmp_path, monkeypatch, "multiFaExtract",
                lambda d: [files["aln"], "-bed", files["extract_bed"],
                           *gaps])
    assert sorted(got) == ["chr1.0.30.fa", "chr1.400.560.fa",
                           "chr9.100.180.fa"]


@pytest.mark.parametrize("src,args,want", [
    ("aln", ["50", "50"], "Invalid arguments, start must be lower than end"),
    ("aln", ["10", "5000"], "IndexError: Ran out of chromosome."),
    # an end at the reference length, its first column a base
    ("hand", ["2", "8"], "IndexError: Ran out of chromosome."),
])
def test_multi_fa_extract_exits(files, tmp_path, monkeypatch, src, args,
                                want):
    got = _both(tmp_path, monkeypatch, "multiFaExtract",
                lambda d: [files[src], f"{d}/out.fa", *args])
    assert got == want


def test_multi_fa_reduce_keeps_n_and_gap_columns(files, tmp_path,
                                                 monkeypatch):
    """Without -bedFilename a column is kept where any row differs from
    the first, N and gaps included."""
    got = _both(tmp_path, monkeypatch, "multiFaReduce",
                lambda d: [files["aln"], f"{d}/out.fa"])
    m = np.stack([np.frombuffer(r.encode(), np.uint8)
                  for r in files["rows"].values()])
    cols = np.flatnonzero((m != m[0]).any(axis=0))
    first = got["out.fa"].decode().split(">")[1].split("\n", 1)[1]
    assert first.replace("\n", "") == m[0][cols].tobytes().decode()
    assert ((m[:, cols] == ord("N")) | (m[:, cols] == ord("-"))).any()


@pytest.mark.parametrize("start", ["0", "1000"])
def test_multi_fa_reduce_bed(files, tmp_path, monkeypatch, start):
    """With -bedFilename each kept column's record is named by its bases
    joined by "_" and scored by its column + -refStart."""
    got = _both(tmp_path, monkeypatch, "multiFaReduce", lambda d: [
        files["aln"], f"{d}/out.fa", "-bedFilename", f"{d}/out.bed",
        "-chrom", "chr3", "-refStart", start])
    rows = list(files["rows"].values())
    m = np.stack([np.frombuffer(r.encode(), np.uint8) for r in rows])
    cols = np.flatnonzero((m != m[0]).any(axis=0))
    ref = m[0] != ord("-")
    s0 = int(start)
    assert got["out.bed"].decode().splitlines() == [
        f"chr3\t{s0 + ref[:c].sum()}\t{s0 + ref[:c].sum() + 1}\t"
        + "_".join(r[c] for r in rows) + f"\t{s0 + c}" for c in cols]


def test_multi_fa_reduce_bed_wants_chrom(files, tmp_path, monkeypatch):
    got = _both(tmp_path, monkeypatch, "multiFaReduce", lambda d: [
        files["aln"], f"{d}/out.fa", "-bedFilename", f"{d}/out.bed"])
    assert got == "Error: using -bedFilename without -chrom"


def test_merge_multi_fa(files, tmp_path, monkeypatch):
    """The merged rows of both files; the walk stops when b's reference
    runs out, dropping a's trailing columns."""
    got = _both(tmp_path, monkeypatch, "mergeMultiFa", lambda d: [
        files["merge_a"], files["merge_b"], f"{d}/out.fa"])
    recs = fasta.read(str(tmp_path / "port" / "out.fa"))
    assert [r.name for r in recs] == ["hg38", "panTro6", "gorGor5", "mm10",
                                      "rn7"]
    merged = recs[0].seq[recs[0].seq != 10]
    ref = fasta.read(files["merge_a"])[0].seq
    ref = ref[ref != 10]
    assert 0 < len(merged) < len(ref)
    assert np.array_equal(merged, ref[:len(merged)])
    assert len(recs[0].seq) < files["merge_a_len"] + files["merge_b_len"]
    assert got["out.fa"].count(b">") == 5


@pytest.mark.parametrize("b,want", [
    ("merge_b_lower", "Reference sequences at alignment position"),
    ("merge_b_name", "does not match the second file reference name"),
    ("merge_one", "The second multiFa file has less than two entries"),
    ("merge_uneven", "In the second multiFa file, entry at index 1 is not"),
])
def test_merge_multi_fa_exits(files, tmp_path, monkeypatch, b, want):
    """Among them: the references' codes compare case-sensitively."""
    got = _both(tmp_path, monkeypatch, "mergeMultiFa", lambda d: [
        files["merge_a"], files[b], f"{d}/out.fa"])
    assert want in got


@pytest.mark.parametrize("bg,fg,chrom", [("panTro6", "gorGor5", "chr1"),
                                         ("hg38", "ponAbe3", "chr1"),
                                         ("gorGor5", "hg38", "chr2"),
                                         ("panTro6", "gorGor5", "chrX")])
def test_multi_fa_sequence_swap(files, tmp_path, monkeypatch, bg, fg,
                                chrom):
    got = _both(tmp_path, monkeypatch, "multiFaSequenceSwap", lambda d: [
        files["aln"], files["regions"], bg, fg, chrom, f"{d}/out.fa"])
    recs = fasta.read(str(tmp_path / "port" / "out.fa"))
    rows = files["rows"]
    assert [r.name for r in recs] == list(rows) + [f"{bg}.swapped"]
    # regions sorted and merged, other chroms skipped; positions counted
    # on the first record, not the background
    spans = {"chr1": [(10, 60), (60, 61), (300, 320), (500, 530)],
             "chr2": [(5, 50)]}.get(chrom, [])
    ref_pos = np.cumsum(np.frombuffer(rows["hg38"].encode(), np.uint8)
                        != ord("-")) - 1
    want = np.frombuffer(rows[bg].encode(), np.uint8).copy()
    fgr = np.frombuffer(rows[fg].encode(), np.uint8)
    last_col = 0
    for s, e in spans:
        first = int(np.searchsorted(ref_pos, s))
        last = int(np.searchsorted(ref_pos, e))
        cols = np.arange(max(first, last_col), last)
        want[cols] = fgr[cols]
        last_col = last
    got_row = "".join(got["out.fa"].decode().split(">")[-1]
                      .split("\n")[1:])
    assert got_row == want.tobytes().decode()


@pytest.mark.parametrize("regions,bg,want", [
    ("bad_region", "panTro6", "Error: Invalid swap region."),
    ("regions", "mm10", "queryName mm10 not found in fasta records."),
])
def test_multi_fa_sequence_swap_exits(files, tmp_path, monkeypatch,
                                      regions, bg, want):
    got = _both(tmp_path, monkeypatch, "multiFaSequenceSwap", lambda d: [
        files["aln"], files[regions], bg, "gorGor5", "chr1",
        f"{d}/out.fa"])
    assert got == want


@pytest.mark.parametrize("src,args", [
    ("pair", []), ("pair", ["-swapTandQ"]), ("pair_clean", []),
    ("pair_clean", ["-swapTandQ"]), ("aln", ["-querySeqName", "ponAbe3"]),
    ("aln", ["-querySeqName", "hg38", "-swapTandQ"]), ("hand", [])])
def test_multi_fa_to_chain(files, tmp_path, monkeypatch, src, args):
    got = _both(tmp_path, monkeypatch, "multiFaToChain", lambda d: [
        *args, files[src], "tName", "qName", f"{d}/out.chain"])
    lines = got["out.chain"].decode().split("\n")
    head = lines[0].split(" ")
    assert head[:3] == ["chain", "100", "tName"] and head[-1] == "1"
    assert lines[-3:] == [lines[-3], "", ""] and "\t" not in lines[-3]


def test_multi_fa_to_chain_hand_case(files, tmp_path, monkeypatch):
    """Score 100, id 1; a gap in the target adds query bases, one in the
    query target bases; only the last block is written as its size
    alone, and a blank line follows the chain."""
    got = _both(tmp_path, monkeypatch, "multiFaToChain", lambda d: [
        files["hand"], "t", "q", f"{d}/out.chain"])
    assert got["out.chain"] == (b"chain 100 t 8 + 0 8 q 9 + 0 9 1\n"
                                b"4\t0\t2\n2\t1\t0\n1\n\n")


@pytest.mark.parametrize("src,args,want", [
    ("dot", [], "ValueError: unrecognized dna base in the query sequence"),
    ("dot_t", [], "ValueError: unrecognized dna base in the reference "
                  "sequence"),
    ("short", [], "ValueError: both sequences must be of the same "
                  "alignment length"),
    ("aln", ["-querySeqName", "mm10"],
     "queryName mm10 not found in fasta records."),
])
def test_multi_fa_to_chain_exits(files, tmp_path, monkeypatch, src, args,
                                 want):
    got = _both(tmp_path, monkeypatch, "multiFaToChain", lambda d: [
        *args, files[src], "t", "q", f"{d}/out.chain"])
    assert got == want


def test_fasta_helpers_equal_jax(files):
    """io/fasta.py's multiFa helpers against the JAX's on the seeded
    alignment."""
    recs, jrecs = fasta.read(files["aln"]), jfasta.read(files["aln"])
    n = len(recs[0].seq)
    for c in (0, 1, 57, 300, n - 1, n):
        assert fasta.aln_pos_to_ref_pos(recs[0], c) == \
            jfasta.aln_pos_to_ref_pos(jrecs[0], c)
    for name in ("hg38", "panTro6", "ponAbe3"):
        assert fasta.find_sequence_index(recs, name) == \
            jfasta.find_sequence_index(jrecs, name)
        assert fasta.scan_n(recs, name) == jfasta.scan_n(jrecs, name)
        assert fasta.scan_present_base(recs, name) == \
            jfasta.scan_present_base(jrecs, name)
    assert fasta.scan_present_base_both(recs, "hg38", "gorGor5") == \
        jfasta.scan_present_base_both(jrecs, "hg38", "gorGor5")
    assert fasta.scan_present_base_either(
        recs, "hg38", "gorGor5", "ponAbe3") == \
        jfasta.scan_present_base_either(jrecs, "hg38", "gorGor5", "ponAbe3")
    assert fasta.segregating_columns(recs).tolist() == \
        jfasta.segregating_columns(jrecs).tolist()
    for got, want in zip(fasta.segregating_sites_fasta(recs),
                         jfasta.segregating_sites_fasta(jrecs)):
        assert (got.name, got.seq.tobytes()) == (want.name, want.seq.tobytes())
    c = fasta.copy(recs[1])
    assert not np.shares_memory(c.seq, recs[1].seq)
    assert c.seq.tobytes() == jfasta.copy(jrecs[1]).seq.tobytes()
    got = fasta.remove_gaps([fasta.extract(r, 20, 90, r.name + "x")
                             for r in recs])
    want = jfasta.remove_gaps([jfasta.extract(r, 20, 90, r.name + "x")
                               for r in jrecs])
    assert [(r.name, r.seq.tobytes()) for r in got] == \
        [(r.name, r.seq.tobytes()) for r in want]


def test_find_sequence_index_errors(files):
    for mod in (fasta, jfasta):
        recs = mod.read(files["aln"])
        with pytest.raises(ValueError, match="used for multiple"):
            mod.find_sequence_index(recs + recs[:1], "hg38")
        with pytest.raises(SystemExit, match="queryName x not found"):
            mod.find_sequence_index(recs, "x")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chain_writer_equals_jax(tmp_path, seed):
    """chain_to_string and write_chain (with comments) against the JAX's
    on seeded chains of one to six blocks and both strands."""
    rng = np.random.default_rng(seed)
    chains, jchains = [], []
    for k in range(4):
        blocks = [(int(rng.integers(1, 90)), int(rng.integers(0, 9)),
                   int(rng.integers(0, 9)))
                  for _ in range(int(rng.integers(1, 7)))]
        head = dict(score=int(rng.integers(0, 10**6)), t_name=f"chr{k}",
                    t_size=int(rng.integers(1000, 9000)),
                    t_strand=bool(rng.random() < 0.5), t_start=5, t_end=900,
                    q_name=f"q{k}", q_size=int(rng.integers(1000, 9000)),
                    q_strand=bool(rng.random() < 0.5), q_start=0,
                    q_end=800, id=k + 1)
        chains.append(formats.Chain(**head, alignment=[
            formats.BaseStats(*b) for b in blocks]))
        jchains.append(jformats.Chain(**head, alignment=[
            jformats.BaseStats(*b) for b in blocks]))
    assert [formats.chain_to_string(c) for c in chains] == \
        [jformats.chain_to_string(c) for c in jchains]
    notes = ["#a comment", "#another"]
    formats.write_chain(str(tmp_path / "port.chain"), chains, notes)
    jformats.write_chain(str(tmp_path / "jax.chain"), jchains, notes)
    assert (tmp_path / "port.chain").read_bytes() == \
        (tmp_path / "jax.chain").read_bytes()
    # the port's reader reads the writer's text back
    back, comments = formats.read_chain(str(tmp_path / "port.chain"))
    assert comments == notes
    assert [(c.t_name, len(c.alignment)) for c in back] == \
        [(c.t_name, len(c.alignment)) for c in chains]
