"""The port's SAM and BAM tools of slice 11.7a (``samInfo``,
``samToWig``, ``bedCountBam``, ``bamTagToReadGroup``;
gonomics_tpu_torch/cli/) and the library under them (``io/bai.py``, the
tag helpers and ``get_chrom_start``/``get_chrom_end`` of ``io/sam.py``)
on the CPU against the JAX package: the bytes of every file the tools
write (BAM as its decompressed payload, since BGZF bytes may differ) and
the message of every exit, on a coordinate-sorted SAM that a numpy seed
builds here and its BAM. The reads have M, I, D, S and N (a few spanning
more than one 16 kbp window, one ending in D), both strands, mates that
share a name, MAPQ values above 60, N bases, reads longer than 200 bp,
tags of types i, Z and A, an RG tag first in some, and unmapped reads
with no reference. The repository has no BAI writer, so the ``.bai``
comes from ``chip_smoke.write_bai``, the fixture that chip_smoke.py
builds its own with; it is held here against the JAX ``read_bai`` and
seek: the JAX seek equals a full scan of the BAM, and the port's seek
equals the JAX's. Each quirk of the reference that the port keeps is
pinned by a case here.
"""

import gzip
import os
import sys

import numpy as np
import pytest

from gonomics_tpu.cli import bam_tag_to_read_group as jbam_tag
from gonomics_tpu.cli import bed_count_bam as jbed_count_bam
from gonomics_tpu.cli import sam_info as jsam_info
from gonomics_tpu.cli import sam_to_wig as jsam_to_wig
from gonomics_tpu.io import bai as jbai
from gonomics_tpu.io import sam as jsam
from gonomics_tpu_torch.cli import bam_tag_to_read_group as bam_tag
from gonomics_tpu_torch.cli import bed_count_bam, sam_info, sam_to_wig
from gonomics_tpu_torch.cli.mergesort import main as mergesort
from gonomics_tpu_torch.io import bai, sam

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import write_bai  # noqa: E402

TOOLS = {"samInfo": (jsam_info.main, sam_info.main),
         "samToWig": (jsam_to_wig.main, sam_to_wig.main),
         "bedCountBam": (jbed_count_bam.main, bed_count_bam.main),
         "bamTagToReadGroup": (jbam_tag.main, bam_tag.main)}

SIZES = [("chrA", 70_000), ("chrB", 36_000), ("chrC", 5_000)]


def _read_out(path: str) -> bytes:
    """A file's bytes; a BAM's decompressed payload."""
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _both(tmp_path, tool: str, argv, chdir=None) -> dict | str:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own (the working directory too where chdir is given),
    and holds their exits and the files they wrote equal; returns the
    port's {name: bytes}, or its exit: the SystemExit's message, or the
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
        except Exception as e:  # the JAX tools' ZeroDivisionError, ...
            exit_msg = f"{type(e).__name__}: {e}"
        files = {n: _read_out(os.path.join(d, n))
                 for n in sorted(os.listdir(d))}
        seen[side] = (exit_msg, files)
    assert seen["port"] == seen["jax"]
    exit_msg, files = seen["port"]
    return exit_msg if exit_msg is not None else files


def _reads(rng) -> list[str]:
    """Coordinate-sorted SAM lines over SIZES' chrA and chrB."""
    rows = []
    sizes = dict(SIZES)
    for i in range(700):
        chrom = "chrA" if rng.random() < 0.7 else "chrB"
        start = int(rng.integers(1, sizes[chrom] - 26_000))
        m = int(rng.integers(20, 110))
        kind = rng.random()
        if kind < 0.02:
            cig = [(m, "M"), (int(rng.integers(17_000, 24_000)), "N"),
                   (30, "M")]
        elif kind < 0.12:
            cig = [(m, "M"), (int(rng.integers(1, 6)), "D"), (25, "M")]
        elif kind < 0.2:
            cig = [(3, "S"), (m, "M"), (2, "I"), (20, "M")]
        elif kind < 0.22:
            cig = [(230, "M")]
        elif kind < 0.24:
            cig = [(m, "M"), (4, "D")]
        else:
            cig = [(m, "M")]
        n_seq = sum(n for n, op in cig if op in "MIS")
        seq = rng.choice(list("ACGTN"), n_seq, p=[.24, .24, .24, .24, .04])
        mapq = int(rng.choice([0, 13, 30, 60, 60, 61, 70, 255]))
        pair = i % 3 == 0
        flag = (16 if rng.random() < 0.5 else 0) | (65 if pair else 0)
        qual = "*" if i % 2 else "".join(
            chr(33 + int(q)) for q in rng.integers(2, 40, n_seq))
        tags = [f"AS:i:{int(rng.integers(40, 44))}",
                f"NM:i:{int(rng.integers(0, 4))}"]
        if i % 5 == 0:
            tags.insert(0, f"RG:Z:old{i % 2}")
        elif i % 5 == 1:
            tags.append("RG:Z:old2")
        if i % 7 == 0:
            tags.append("XA:A:q")
        if i % 11 == 0:
            tags.append("XS:Z:tail")
        cigar = "".join(f"{n}{op}" for n, op in cig)
        name = f"p{i}" if pair else f"q{i}"
        rows.append((chrom, start, name, flag, mapq, cigar, "".join(seq),
                     qual, "\t".join(tags)))
        if pair:  # the second mate, under the same name
            mate = min(start + int(rng.integers(50, 400)),
                       sizes[chrom] - 200)
            rows.append((chrom, mate, name, 129 if flag & 16 else 145, mapq,
                         "40M", "".join(rng.choice(list("ACGT"), 40)), "*",
                         "AS:i:40"))
    # one name and first-in-pair flag twice: a seek keeps one of them
    rows += [("chrA", 5000, "dup", 0, 60, f"{n}M", "A" * n, "*", "AS:i:1")
             for n in (30, 31)]
    # fragments that -fragLength clips: a - read at chrA's start, a + read
    # at chrB's end
    rows += [("chrA", 10, "left", 16, 60, "40M", "C" * 40, "*", "AS:i:2"),
             ("chrB", 35_900, "right", 0, 60, "40M", "G" * 40, "*",
              "AS:i:2")]
    rows.sort(key=lambda r: (r[0], r[1]))
    lines = [f"{q}\t{f}\t{c}\t{p}\t{mq}\t{cig}\t*\t0\t0\t{s}\t{ql}\t{t}"
             for c, p, q, f, mq, cig, s, ql, t in rows]
    unmapped = [f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\tACGTNACG\t*" for i in range(4)]
    return unmapped + lines


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """in.sam, its BAM (the port's mergesort), the BAM's .bai, the sizes,
    named regions and the tag values, under one directory."""
    d = tmp_path_factory.mktemp("sam_tools")
    rng = np.random.default_rng(2611)
    head = ["@HD\tVN:1.6\tSO:coordinate"]
    head += [f"@SQ\tSN:{c}\tLN:{n}" for c, n in SIZES]
    head += ["@RG\tID:old0\tSM:x", "@RG\tID:old1\tSM:y"]
    f = {k: str(d / k) for k in ("in.sam", "in.bam", "sizes", "short.sizes",
                                  "regions.bed", "zero.bed", "values.txt")}
    with open(f["in.sam"], "w") as fh:
        fh.writelines(ln + "\n" for ln in head + _reads(rng))
    mergesort([f["in.sam"], f["in.bam"]])
    f["index"] = write_bai(f["in.bam"], f["in.bam"] + ".bai")
    with open(f["sizes"], "w") as fh:
        fh.writelines(f"{c}\t{n}\n" for c, n in SIZES)
    with open(f["short.sizes"], "w") as fh:
        fh.write("chrA\t70000\nchrC\t5000\n")
    regions = [("chrA", 0, 70_000), ("chrA", 16_000, 16_800),
               ("chrA", 30_000, 60_000), ("chrB", 100, 101),
               ("chrB", 5_000, 9_000), ("chrB", 35_000, 36_000),
               ("chrC", 0, 5_000), ("chrZ", 0, 100), ("chrA", 0, 1)]
    regions += [("chrA" if rng.random() < 0.6 else "chrB",
                 s, s + int(rng.integers(1, 3000)))
                for s in rng.integers(0, 33_000, 12).tolist()]
    with open(f["regions.bed"], "w") as fh:
        fh.writelines(f"{c}\t{s}\t{e}\tr{i}\n"
                      for i, (c, s, e) in enumerate(regions))
    with open(f["zero.bed"], "w") as fh:
        fh.write("chrA\t100\t200\tfine\nchrA\t500\t500\tempty\n")
    with open(f["values.txt"], "w") as fh:
        fh.write("42\n40\n99\n")
    return f


def test_bai_fixture_read_by_jax(files):
    """The fixture's .bai parses with the JAX reader, with a window a 16
    kbp of reads, the unmapped reads as no-coordinate reads, and the
    port's reader gives the same index."""
    want = jbai.read_bai(files["in.bam"] + ".bai")
    got = bai.read_bai(files["in.bam"] + ".bai")
    assert (got.has_no_coord_reads, got.no_coord_reads) == (True, 4)
    assert [(r.bins, r.interval_off) for r in got.refs] == \
        [(r.bins, r.interval_off) for r in want.refs]
    assert [len(r.interval_off) for r in got.refs][2] == 0
    assert len(got.refs[0].interval_off) >= 3
    assert files["index"]["records"] == len(jsam.read(files["in.sam"])[1]) - 4


def _full_scan(records, chrom, start, end):
    return jbai._deduplicate([s for s in records if s.rname == chrom
                              and jsam.get_chrom_end(s) > start
                              and jsam.get_chrom_start(s) < end])


@pytest.mark.parametrize("chrom,start,end", [
    ("chrA", 0, 70_000), ("chrA", 16_383, 16_385), ("chrA", 20_000, 52_000),
    ("chrA", 44_000, 44_001), ("chrB", 0, 36_000), ("chrB", 32_000, 35_000),
    ("chrC", 0, 5_000), ("chrZ", 0, 10), ("chrA", 69_000, 69_999),
    ("chrB", 30_000, 30_000)])
def test_seek_equals_full_scan(files, chrom, start, end):
    """On the fixture's .bai the JAX seek equals a full scan of the BAM,
    de-duplicated as the seek is, and the port's seek equals the JAX's
    record for record; a chrom missing from the header, or a start past
    a reference's linear index, gives none."""
    _h, _refs, records = jsam.read_bam(files["in.bam"])
    want = jbai.seek_bam_region(files["in.bam"],
                                jbai.read_bai(files["in.bam"] + ".bai"),
                                chrom, start, end)
    got = bai.seek_bam_region(files["in.bam"],
                              bai.read_bai(files["in.bam"] + ".bai"),
                              chrom, start, end)
    key = [(s.qname, s.flag, s.pos) for s in want]
    assert key == [(s.qname, s.flag, s.pos)
                   for s in _full_scan(records, chrom, start, end)]
    assert [(s.to_string(), s._raw_tags) for s in got] == \
        [(s.to_string(), s._raw_tags) for s in want]
    if chrom in ("chrC", "chrZ") or start >= 69_000:
        assert got == []


def test_seek_windows_seeded(files):
    """Seventy seeded regions: the port's seek equals the JAX's and a
    full scan, records out of position order where names say so."""
    rng = np.random.default_rng(7)
    _h, _refs, records = jsam.read_bam(files["in.bam"])
    index_j = jbai.read_bai(files["in.bam"] + ".bai")
    index_t = bai.read_bai(files["in.bam"] + ".bai")
    for _ in range(70):
        chrom, size = SIZES[int(rng.integers(0, 2))]
        start = int(rng.integers(0, size))
        end = start + int(rng.integers(0, 20_000))
        want = jbai.seek_bam_region(files["in.bam"], index_j, chrom, start,
                                    end)
        got = bai.seek_bam_region(files["in.bam"], index_t, chrom, start, end)
        assert [s.to_string() for s in got] == [s.to_string() for s in want]
        assert [(s.qname, s.flag) for s in want] == \
            [(s.qname, s.flag) for s in _full_scan(records, chrom, start, end)]


def test_seek_keeps_one_record_a_name_and_flag(files):
    """Two records of one name and first-in-pair flag: the seek keeps the
    first; the two mates of a pair are both kept, the first mate first."""
    for mod in (jbai, bai):
        hits = mod.seek_bam_region(files["in.bam"], mod.read_bai(
            files["in.bam"] + ".bai"), "chrA", 5000, 5010)
        dup = [s for s in hits if s.qname == "dup"]
        assert [s.cigar[0].run_length for s in dup] == [30]
        names = [s.qname for s in hits]
        assert names == sorted(names)
    _h, _r, records = jsam.read_bam(files["in.bam"])
    pair = [s for s in _full_scan(records, "chrA", 0, 70_000)
            if s.qname.startswith("p")][:2]
    assert pair[0].qname == pair[1].qname
    assert [bool(s.flag & 64) for s in pair] == [True, False]


def test_seek_start_after_end_raises(files):
    for mod in (jbai, bai):
        with pytest.raises(ValueError, match="start > end"):
            mod.seek_bam_region(files["in.bam"], mod.read_bai(
                files["in.bam"] + ".bai"), "chrA", 10, 9)


def test_region_to_bins_equals_jax():
    """Levels 1-5 only (no root bin 0) for a mapped region; the unmapped
    list for (-1, 0)."""
    rng = np.random.default_rng(8)
    pairs = [(-1, 0), (0, 1), (16_383, 16_385), (0, 1 << 26),
             (131_071, 131_073)]
    pairs += [(int(s), int(s) + int(n)) for s, n in zip(
        rng.integers(0, 1 << 28, 40), rng.integers(1, 1 << 21, 40))]
    for beg, end in pairs:
        assert bai.region_to_bins(beg, end) == jbai.region_to_bins(beg, end)
    assert 0 not in bai.region_to_bins(0, 1 << 26)


def test_read_bai_refuses_bad_files(files, tmp_path):
    with open(files["in.bam"] + ".bai", "rb") as f:
        good = f.read()
    for name, data in (("magic.bai", b"BAJ\x01" + good[4:]),
                       ("extra.bai", good + b"\x00\x00\x00")):
        path = tmp_path / name
        path.write_bytes(data)
        msgs = []
        for mod in (jbai, bai):
            with pytest.raises(ValueError) as e:
                mod.read_bai(str(path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("sub,src,args", [
    ("readLength", "in.sam", []), ("readLength", "in.bam", []),
    ("coverage", "in.sam", []),
    ("coverage", "in.bam", ["-highEndFilter", "0.05", "-countNinDepth"]),
    ("mapq", "in.sam", []), ("mapq", "in.bam", []),
    ("mapq", "in.bam", ["-bedfile", "regions.bed"])])
def test_sam_info(files, tmp_path, sub, src, args):
    """The three histograms: readLength grown past 200 rows by the
    230 bp reads; coverage's Lambda, threshold and Expected rows; mapq's
    values above 60 in the order first met, and -bedfile counting a read
    once a region it lies in."""
    outs = ["out.txt"] + (["stats.txt"] if sub == "coverage" else [])
    d = os.path.dirname(files["in.sam"])
    extra = [os.path.join(d, a) if a.endswith(".bed") else a for a in args]
    got = _both(tmp_path, "samInfo", lambda o: [
        sub, files[src], *[os.path.join(o, n) for n in outs], *extra])
    text = got["out.txt"].decode()
    if sub == "readLength":
        assert len(text.splitlines()) == 231 + 10
    if sub == "mapq" and not args:
        keys = [ln.split("\t")[0] for ln in text.splitlines()[1:]]
        assert keys[:61] == [str(i) for i in range(61)]
        assert sorted(keys[61:]) == ["255", "61", "70"]
    if sub == "coverage":
        assert got["stats.txt"].startswith(b"Lambda\t")
        assert "\tExpected\t" in text


def test_sam_info_mapq_bedfile_counts_overlaps_twice(files, tmp_path):
    """A read in two overlapping regions counts in each."""
    bed = tmp_path / "twice.bed"
    bed.write_text("chrA\t20000\t30000\ta\nchrA\t20000\t30000\tb\n")
    got = _both(tmp_path, "samInfo", lambda o: [
        "mapq", files["in.bam"], os.path.join(o, "o.txt"), "-bedfile",
        str(bed)])
    rows = [ln.split("\t") for ln in got["o.txt"].decode().splitlines()[1:]]
    _h, _r, records = jsam.read_bam(files["in.bam"])
    hits = _full_scan(records, "chrA", 20_000, 30_000)
    assert sum(int(n) for _, n in rows) == 2 * len(hits)


@pytest.mark.parametrize("argv,want", [
    ([], "Error: user must specify a samInfo subcommand."),
    (["bogus"], "Error: unrecognized subcommand: bogus.")])
def test_sam_info_exits(tmp_path, argv, want):
    assert _both(tmp_path, "samInfo", lambda o: argv) == want


@pytest.mark.parametrize("src", ["in.sam", "in.bam"])
@pytest.mark.parametrize("args", [[], ["-fragLength", "300"],
                                  ["-deletions"],
                                  ["-defaultValue", "-1", "-deletions"]])
def test_sam_to_wig(files, tmp_path, src, args):
    """Coverage as wig: simple spans, fragments clipped at 0 and at the
    chrom's end, and spans cut at each D (a cigar ending in D writes no
    last piece)."""
    got = _both(tmp_path, "samToWig", lambda o: [
        files[src], files["sizes"], os.path.join(o, "out.wig"), *args])
    assert got["out.wig"].startswith(b"fixedStep chrom=chrA")


@pytest.mark.parametrize("sizes,args", [
    ("sizes", ["-fragLength", "100"]),
    ("sizes", ["-fragLength", "300", "-deletions"]),
    ("short.sizes", []), ("short.sizes", ["-fragLength", "300"])])
def test_sam_to_wig_exits(files, tmp_path, sizes, args):
    """A fragment shorter than a read exits (the unmapped reads come
    first, so the check fires before any mapped test); -fragLength with
    -deletions exits; a chrom missing from the sizes exits (a KeyError
    under -fragLength, where the clip looks the size up first)."""
    got = _both(tmp_path, "samToWig", lambda o: [
        files["in.sam"], files[sizes], os.path.join(o, "out.wig"), *args])
    assert isinstance(got, str)


def test_sam_to_wig_frag_length_checks_unmapped_reads(tmp_path):
    """The fragment length is checked before the unmapped test, so an
    unmapped read longer than it exits."""
    src = tmp_path / "u.sam"
    src.write_text("@SQ\tSN:chrA\tLN:100\nr\t0\tchrA\t1\t60\t20M\t*\t0\t0\t"
                   + "A" * 20 + "\t*\nu\t4\t*\t0\t0\t*\t*\t0\t0\t" + "C" * 40
                   + "\t*\n")
    sizes = tmp_path / "s.sizes"
    sizes.write_text("chrA\t100\n")
    assert _both(tmp_path, "samToWig", lambda o: [
        str(src), str(sizes), os.path.join(o, "o.wig"), "-fragLength",
        "30"]) == "fragLength is shorter than the sam read length"


@pytest.mark.parametrize("bed,norm", [("regions.bed", False),
                                      ("regions.bed", True),
                                      ("zero.bed", False), ("zero.bed", True)])
def test_bed_count_bam(files, tmp_path, bed, norm):
    """Counts of distinct (name, first-in-pair) reads a region, under the
    header that -norm changes; -norm of a region of length 0 raises
    ZeroDivisionError."""
    d = os.path.dirname(files["in.sam"])
    got = _both(tmp_path, "bedCountBam", lambda o: [
        files["in.bam"], os.path.join(d, bed), os.path.join(o, "out.txt"),
        *(["-norm"] if norm else [])])
    if bed == "zero.bed" and norm:
        assert got.startswith("ZeroDivisionError")
        return
    lines = got["out.txt"].decode().splitlines()
    assert lines[0] == ("bedRegion\tcountsPerBP" if norm
                        else "bedRegion\tcounts")
    if bed == "regions.bed" and not norm:
        counts = dict(ln.split("\t") for ln in lines[1:])
        _h, _r, records = jsam.read_bam(files["in.bam"])
        assert int(counts["r0"]) == len(_full_scan(records, "chrA", 0,
                                                   70_000)) > 0
        assert counts["r6"] == counts["r7"] == "0"


@pytest.mark.parametrize("src", ["in.bam", "in.sam"])
@pytest.mark.parametrize("tag", ["AS", "NM", "XA", "RG"])
def test_bam_tag_to_read_group(files, tmp_path, src, tag):
    """The header's @RG lines replaced by the values' lines in file
    order; each record's first RG tag removed (BAM tags turned to text,
    A tags dropped there) and RG:Z:v added where its tag's field[5:] is
    listed; the BAM payloads equal."""
    got = _both(tmp_path, "bamTagToReadGroup", lambda o: [
        "-i", files[src], "-o", os.path.join(o, "out.bam"), "-tagId", tag,
        "-tagValues", files["values.txt"]])
    payload = got["out.bam"]
    assert payload[:4] == b"BAM\x01"
    text = payload[8:8 + int.from_bytes(payload[4:8], "little")].decode()
    assert [ln for ln in text.split("\n") if ln.startswith("@RG")] == \
        [f"@RG\tID:{v}\tSM:{v}\tLB:{v}" for v in ("42", "40", "99")]
    _h, records = jsam.read(os.path.join(tmp_path, "port", "out.bam"))
    rg = [jsam._tags_to_text(r._raw_tags) for r in records]
    n_rg = sum("RG:Z:" in t for t in rg)
    if tag == "AS":
        assert n_rg > 0 and all(
            ("RG:Z:4" in t) == ("AS:i:42" in t or "AS:i:40" in t) for t in rg)
    else:
        assert n_rg == 0


def test_bam_tag_to_read_group_default_output(files, tmp_path, monkeypatch):
    """-o defaults to a file named stdout in the working directory."""
    got = _both(tmp_path, "bamTagToReadGroup", lambda o: [
        "-i", files["in.bam"], "-tagId", "AS", "-tagValues",
        files["values.txt"]], chdir=monkeypatch.chdir)
    assert list(got) == ["stdout"] and got["stdout"][:4] == b"BAM\x01"


@pytest.mark.parametrize("tag", ["A", "ABC"])
def test_bam_tag_to_read_group_tag_id_exits(files, tmp_path, tag):
    assert _both(tmp_path, "bamTagToReadGroup", lambda o: [
        "-i", files["in.bam"], "-o", os.path.join(o, "out.bam"), "-tagId",
        tag, "-tagValues", files["values.txt"]]) == \
        "Error: -tagId must be 2 characters"


@pytest.fixture
def record_pairs(files):
    """(JAX record, port record) of every BAM and SAM record."""
    out = []
    for src in ("in.bam", "in.sam"):
        _hj, want = jsam.read(files[src])
        _ht, got = sam.read(files[src])
        out += list(zip(want, got))
    return out


def test_chrom_start_end_equal_jax(record_pairs):
    for want, got in record_pairs:
        assert (sam.get_chrom_start(got), sam.get_chrom_end(got)) == \
            (jsam.get_chrom_start(want), jsam.get_chrom_end(want))


@pytest.mark.parametrize("op", [("remove", "RG"), ("remove", "NM"),
                                ("remove", "ZZ"), ("remove", "AS"),
                                ("add", "RG", "Z", "grp"),
                                ("add", "XY", "i", "7"), ("parse",)])
def test_tag_helpers_equal_jax(record_pairs, op):
    """parse_extra, remove_tag (the first match only) and add_tag give
    the JAX's extra on every record, BAM tags turned to text first."""
    fn = {"remove": "remove_tag", "add": "add_tag", "parse": "parse_extra"}
    for want, got in record_pairs:
        getattr(jsam, fn[op[0]])(want, *op[1:])
        getattr(sam, fn[op[0]])(got, *op[1:])
        assert got.extra == want.extra
        assert getattr(got, "_raw_tags", None) is None


def test_remove_tag_first_match_only():
    """Two RG tags lose the first; a tag at the start goes by its two
    letters; a one-letter tag id or a bad type raises."""
    for mod in (jsam, sam):
        s = mod.Sam(extra="AS:i:1\tRG:Z:a\tNM:i:0\tRG:Z:b")
        mod.remove_tag(s, "RG")
        assert s.extra == "AS:i:1\tNM:i:0\tRG:Z:b"
        s = mod.Sam(extra="RG:Z:a")
        mod.remove_tag(s, "RG")
        assert s.extra == ""
        mod.add_tag(s, "RG", "Z", "c")
        assert s.extra == "RG:Z:c"
        with pytest.raises(ValueError, match="2 characters"):
            mod.remove_tag(s, "R")
        with pytest.raises(ValueError, match="one of A,i,f,Z,H,B"):
            mod.add_tag(s, "XY", "Q", "1")
