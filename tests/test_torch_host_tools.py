"""The port's ``faFormat``, ``bedMerge``, ``bedToWig``, ``intervalOverlap``
and ``mergesort`` (gonomics_tpu_torch/cli/) on the CPU against the JAX
tools: the bytes of every output file, and the message of every exit,
on inputs that a numpy seed builds here. ``.gz`` outputs are compared
as their text, and ``.bam`` outputs as the payload under the BGZF
blocks and as the records the JAX reader reads back. Also the library
copies under them (``dna.from_string_forced``,
``fasta.aln_pos_to_ref_pos_counter``, ``wig.go_fmt_g``,
``native.compress_blocks``, the BGZF writer's zlib path,
``IntervalIndex``) against the JAX's.
"""

import gzip
import os

import numpy as np
import pytest

from gonomics_tpu import dna as jdna
from gonomics_tpu import interval as jinterval
from gonomics_tpu import native as jnative
from gonomics_tpu.cli import bed_merge as jbed_merge
from gonomics_tpu.cli import bed_to_wig as jbed_to_wig
from gonomics_tpu.cli import fa_format as jfa_format
from gonomics_tpu.cli import interval_overlap as jinterval_overlap
from gonomics_tpu.cli import mergesort as jmergesort
from gonomics_tpu.io import bam_writer as jbam_writer
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import sam as jsam
from gonomics_tpu.io import wig as jwig
from gonomics_tpu_torch import dna, interval, native
from gonomics_tpu_torch.cli import bed_merge, bed_to_wig, fa_format
from gonomics_tpu_torch.cli import interval_overlap, mergesort
from gonomics_tpu_torch.io import bam_writer, fasta, sam, wig

TOOLS = {"faFormat": (jfa_format.main, fa_format.main),
         "bedMerge": (jbed_merge.main, bed_merge.main),
         "bedToWig": (jbed_to_wig.main, bed_to_wig.main),
         "intervalOverlap": (jinterval_overlap.main, interval_overlap.main),
         "mergesort": (jmergesort.main, mergesort.main)}


def _content(path: str) -> bytes:
    """A file's bytes; the text of a gzip file, the payload of a BAM."""
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _both(tmp_path, tool: str, argv) -> dict:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits and the files they wrote equal;
    returns the port's {file name: content}, or its exit message."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        try:
            main(argv(str(d)))
            exit_msg = None
        except SystemExit as e:
            exit_msg = str(e)
        files = {n: _content(str(d / n)) for n in sorted(os.listdir(d))}
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


def _seq(rng, n: int, alphabet: str) -> str:
    """n characters of alphabet, with runs of gaps and Ns."""
    s = list(rng.choice(list(alphabet), n))
    for _ in range(n // 40):
        a, k = int(rng.integers(0, max(n - 8, 1))), int(rng.integers(1, 8))
        s[a:a + k] = [rng.choice(["-", "N", "n"])] * k
    return "".join(s)[:n]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_tools")
    rng = np.random.default_rng(2101)
    f = {}
    # faFormat: lower case, gaps, N, an empty record, a name with spaces
    recs = [("chr1", _seq(rng, 230, "ACGTacgt")),
            ("chr2", _seq(rng, 97, "ACGTNacgt-")),
            ("chr3 with a description", _seq(rng, 64, "ACGT")),
            ("empty", ""), ("chr4", _seq(rng, 120, "acgtn"))]
    f["fa"] = _write(tmp / "in.fa", _fa_text(recs, 50))
    bad = [(n, "".join(c if rng.random() > 0.08 else
                       rng.choice(list("XRyk?*.")) for c in s))
           for n, s in recs]
    f["bad_fa"] = _write(tmp / "bad.fa", _fa_text(bad, 33))
    aln = [(n, _seq(rng, 150, "ACGT--acgt")) for n in ("ref", "seqB",
                                                         "seqC")]
    f["multi_fa"] = _write(tmp / "multi.fa", _fa_text(aln))
    f["names"] = _write(tmp / "names.txt", "chr2\nchr4\nchrNone\n")
    regions = "chr1\t0\t40\nchr1\t100\t180\nchr2\t5\t60\tx\t3\nchr4\t0\t1\n"
    f["lower_bed"] = _write(tmp / "lower.bed", regions)
    f["lower_bed_extra"] = _write(tmp / "lower_extra.bed",
                                  regions + "chrMissing\t0\t10\n")

    # bedMerge: overlapping, touching and nearby records on 3 chromosomes
    beds = []
    for i in range(70):
        chrom = ["chr1", "chr2", "chr10"][int(rng.integers(0, 3))]
        s = int(rng.integers(0, 400))
        e = s + int(rng.integers(1, 25))
        beds.append((chrom, s, e, f"r{i}", int(rng.integers(0, 1000)),
                     "+-."[int(rng.integers(0, 3))]))
    beds += [("chr1", 500, 510, "t0", 5, "+"), ("chr1", 510, 520, "t1", 9,
                                                 "-"),
             ("chr1", 522, 530, "t2", 1, "."), ("chr1", 534, 540, "", 2,
                                                 ".")]
    beds = [beds[i] for i in rng.permutation(len(beds))]
    line = "{}\t{}\t{}\t{}\t{}\t{}\n".format
    f["bed6"] = _write(tmp / "u6.bed", "".join(line(*b) for b in beds))
    f["bed6_sorted"] = _write(tmp / "s6.bed", "".join(
        line(*b) for b in sorted(beds, key=lambda b: b[:3])))
    f["bed3"] = _write(tmp / "u3.bed", "".join(
        "\t".join(map(str, b[:3])) + "\n" for b in beds))
    f["bed_empty"] = _write(tmp / "empty.bed", "")

    # bedToWig: records with distinct midpoints and disjoint ranges; one
    # pair sharing a midpoint; one pair of overlapping ranges
    f["sizes"] = _write(tmp / "ref.sizes",
                        "chr1\t300\nchr2\t200\nchr3\t50\n")
    points = []
    for chrom, n in (("chr1", 300), ("chr2", 200)):
        cuts = np.sort(rng.choice(np.arange(1, n), 24, replace=False))
        for s, e in zip(cuts[0::2], cuts[1::2]):
            value = rng.choice([f"{rng.normal() * 10:.3f}", "1e+20",
                                "-0.5", "7", "3.25e-05"])
            points.append(f"{chrom}\t{s}\t{e}\t{value}\t"
                          f"{int(rng.integers(1, 900))}\t+\t"
                          f"{int(rng.integers(-5, 50))}\t"
                          f"{rng.random():.6g}\n")
    f["points"] = _write(tmp / "points.bed", "".join(points))
    f["clash"] = _write(tmp / "clash.bed", "chr1\t10\t20\t1\t5\n"
                        "chr1\t12\t18\t2\t6\n")
    f["overlap"] = _write(tmp / "overlap.bed", "chr1\t10\t20\t1\t5\n"
                          "chr1\t18\t30\t2\t6\nchr2\t0\t200\t3\t7\n")

    # intervalOverlap: regions, and queries made from them so that every
    # relationship has hits (shifted, inside, around, meeting, sharing a
    # start or an end, equal, single bases), plus random ones
    sel = []
    for i in range(40):
        chrom = ["chr1", "chr2"][i % 2]
        s = int(rng.integers(0, 600))
        sel.append((chrom, s, s + int(rng.integers(1, 40))))
    sel.append(("chr1", 700, 701))
    qs = []
    for chrom, s, e in sel:
        n = e - s
        for qs_, qe in ((s - 3, s + n // 2 + 1), (s + n // 2, e + 4),
                        (s + 1, max(e - 1, s + 2)), (s - 2, e + 2),
                        (e, e + 5), (s - 5, s), (s, e + 3),
                        (s, max(s + 1, e - 1)), (s - 3, e),
                        (min(s + 1, e - 1), e), (s, e), (s, s + 1),
                        (e - 1, e)):
            if 0 <= qs_ < qe:
                qs.append((chrom, qs_, qe))
    for _ in range(30):
        chrom = ["chr1", "chr2", "chr3"][int(rng.integers(0, 3))]
        s = int(rng.integers(0, 700))
        qs.append((chrom, s, s + int(rng.integers(1, 60))))
    qs = [qs[i] for i in rng.permutation(len(qs))][:250]
    f["select"] = _write(tmp / "select.bed", "".join(
        f"{c}\t{s}\t{e}\tsel{i}\t{i}\n" for i, (c, s, e) in enumerate(sel)))
    f["query"] = _write(tmp / "query.bed", "".join(
        f"{c}\t{s}\t{e}\n" for c, s, e in qs))
    with gzip.open(tmp / "query.bed.gz", "wt") as fh:
        fh.write("".join(f"{c}\t{s}\t{e}\tq{i}\n"
                         for i, (c, s, e) in enumerate(qs[:120])))
    f["query_gz"] = str(tmp / "query.bed.gz")
    vcf_head = ("##fileformat=VCFv4.2\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n")
    vrecs = []
    for i, (c, s, e) in enumerate(qs[:90]):
        # a REF of n > 1 bases spans [pos, pos + n - 1); of 1, [pos - 1, pos)
        pos, n = (s, e - s + 1) if i % 2 and s else (s + 1, 1 + i % 5)
        ref = "".join(rng.choice(list("ACGT"), n))
        vrecs.append(f"{c}\t{pos}\t.\t{ref}\tA\t30\tPASS\t.\tGT\t0/1\n")
    f["query_vcf"] = _write(tmp / "query.vcf", vcf_head + "".join(vrecs))

    # mergesort: bed with tied keys, VCF with samples, SAM (unsorted, with
    # unmapped reads, mates sharing a name and tags of each type) and its
    # BAM, axt with '#' lines, and a FASTQ pair
    bed_rows = [(["chr1", "chr2", "chr10"][int(rng.integers(0, 3))],
                 int(rng.integers(0, 50)), 0) for _ in range(60)]
    f["sort_bed"] = _write(tmp / "sort.bed", "".join(
        f"{c}\t{s}\t{s + 1 + i % 3}\tn{i}\n"
        for i, (c, s, _) in enumerate(bed_rows)))
    with gzip.open(tmp / "sort2.bed.gz", "wt") as fh:
        fh.write("".join(f"{c}\t{s}\t{s + 5}\n" for c, s, _ in bed_rows))
    f["sort_bed_gz"] = str(tmp / "sort2.bed.gz")
    vl = []
    for i in range(50):
        c = ["chr1", "chr2", "chr10"][int(rng.integers(0, 3))]
        vl.append(f"{c}\t{int(rng.integers(1, 30))}\tid{i}\tA\t"
                  f"{'CGT'[i % 3]}\t{i}.5\tPASS\tDP={i}\tGT:DP\t"
                  f"{i % 2}|1:{i}\n")
    f["sort_vcf"] = _write(tmp / "sort.vcf", "##fileformat=VCFv4.2\n"
                           "##contig=<ID=chr1>\n" + vcf_head + "".join(vl))
    f["sort_sam"] = _write(tmp / "sort.sam", _sam_text(rng))
    header, records = jsam.read(f["sort_sam"])
    f["sort_bam"] = str(tmp / "sort.bam")
    jbam_writer.write_bam(f["sort_bam"], header, records)
    axt = ["##matrix=axtChain 16 91,-114,-31,-123\n"]
    for i in range(25):
        c = ["chr1", "chr2"][int(rng.integers(0, 2))]
        s = int(rng.integers(1, 40))
        n = int(rng.integers(3, 12))
        t = "".join(rng.choice(list("ACGTacgt-"), n))
        q = "".join(rng.choice(list("ACGTN-"), n))
        axt.append(f"{i} {c} {s} {s + n - 1} q{c} {s} {s + n - 1} "
                   f"{'+-'[i % 2]} {int(rng.integers(-50, 500))}\n"
                   f"{t}\n{q}\n\n")
        if i == 12:
            axt.append("# a comment between blocks\n")
    f["sort_axt"] = _write(tmp / "sort.axt", "".join(axt))
    for k in (1, 2):
        names = rng.permutation(30)
        f[f"fq{k}"] = _write(tmp / f"r{k}.fq", "".join(
            f"@read{j} {k}:N:0\n{''.join(rng.choice(list('ACGTN'), 12))}\n"
            f"+\n{''.join(chr(33 + int(x)) for x in rng.integers(0, 41, 12))}"
            "\n" for j in names))
    return f


def _sam_text(rng) -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted", "@SQ\tSN:chr1\tLN:5000",
             "@SQ\tSN:chr2\tLN:3000", "@SQ\tSN:chr10\tLN:2000",
             "@PG\tID:test\tPN:test"]
    cigars = [("20M", 20), ("5S10M2I3M", 20), ("8M3D12M", 20),
              ("4M100N16M", 20)]
    tags = ["AS:i:-3\tNM:i:2", "XS:Z:abc\tXA:A:c", "XF:f:1.5",
            "ZB:B:S,1,200,3", ""]
    for i in range(45):
        name = f"q{i // 2}"
        seq = "".join(rng.choice(list("ACGTN"), 20))
        qual = ("*" if i % 5 == 0 else
                "".join(chr(33 + int(x)) for x in rng.integers(0, 41, 20)))
        extra = tags[i % len(tags)]
        tail = f"\t{extra}" if extra else ""
        if i % 9 == 4:
            lines.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}"
                         f"{tail}")
            continue
        chrom = ["chr1", "chr2", "chr10"][int(rng.integers(0, 3))]
        cig, _ = cigars[int(rng.integers(0, len(cigars)))]
        pos = int(rng.integers(1, 40))
        flag = [0, 16, 99, 147][i % 4]
        lines.append(f"{name}\t{flag}\t{chrom}\t{pos}\t{i % 61}\t{cig}\t=\t"
                     f"{pos + 5}\t{25 - i}\t{seq}\t{qual}{tail}")
    return "".join(ln + "\n" for ln in lines)


# case: (input, flags, a word of the exit or None)
FA_FORMAT_CASES = {
    "default": ("fa", [], None),
    "line_length": ("fa", ["-lineLength", "7"], None),
    "to_upper": ("fa", ["-toUpper"], None),
    "to_lower": ("fa", ["-toLower", "lower_bed"], None),
    "to_lower_missing_chrom": ("fa", ["-toLower", "lower_bed_extra"],
                               "chrMissing not in fasta"),
    "to_lower_ignore_extra": ("fa", ["-toLower", "lower_bed_extra",
                                     "-ignoreExtraRegions"], None),
    "rev_comp": ("fa", ["-revComp"], None),
    "no_gaps": ("fa", ["-noGaps"], None),
    "no_gap_bed": ("fa", ["-noGapBed", "{d}/gaps.bed"], None),
    "index": ("fa", ["-index", "-lineLength", "13"], None),
    "mask_invalid": ("bad_fa", ["-maskInvalid"], None),
    "names_file": ("fa", ["-fastaNamesFile", "names", "-toUpper",
                          "-revComp", "-trimName"], None),
    "trim_name": ("fa", ["-trimName"], None),
    "rename": ("fa", ["-rename", "chr2,chrRenamed", "-revComp"], None),
    "rename_malformed": ("fa", ["-rename", "chr2"],
                         "two comma-delimited fields"),
    "multi_fa_no_gap_bed": ("multi_fa", ["-multiFaNoGapBed", "{d}/m.bed",
                                         "-querySeqName", "seqB",
                                         "-chromName", "chrZ"], None),
    "multi_fa_missing_query": ("multi_fa", ["-multiFaNoGapBed",
                                            "{d}/m.bed", "-querySeqName",
                                            "nope", "-chromName", "c"],
                               "not found exactly once"),
    "multi_fa_no_chrom_name": ("multi_fa", ["-multiFaNoGapBed", "{d}/m.bed",
                                            "-querySeqName", "seqB"],
                               "requires querySeqName and chromName"),
    "all_edits": ("bad_fa", ["-maskInvalid", "-toUpper", "-noGaps",
                             "-trimName", "-lineLength", "11", "-index",
                             "-noGapBed", "{d}/gaps.bed", "-toLower",
                             "lower_bed"], None),
}


def _args(files, argv, d):
    return [files.get(a, a).format(d=d) for a in argv]


@pytest.mark.parametrize("case", list(FA_FORMAT_CASES))
def test_fa_format_byte_identical(files, tmp_path, case):
    """faFormat's FASTA, .fai and beds, or its exit, equal the JAX
    tool's for each flag."""
    src, flags, exit_word = FA_FORMAT_CASES[case]
    got = _both(tmp_path, "faFormat", lambda d: [
        files[src], f"{d}/out.fa", *_args(files, flags, d)])
    if exit_word:
        assert exit_word in got
        return
    assert got["out.fa"]
    if "-index" in flags:
        assert got["out.fa.fai"]
    if case == "names_file":  # every record written, only named ones edited
        text = got["out.fa"].decode()
        assert ">chr2_RevComp" in text and ">chr1\n" in text
        assert ">chr3 with a description" in text


BED_MERGE_FLAGS = [[], ["-mergeAdjacent"], ["-pad", "0"], ["-pad", "3"],
                   ["-keepAllNames"], ["-lowMem"], ["-lowMem", "-pad", "2"],
                   ["-lowMem", "-keepAllNames"],
                   ["-mergeAdjacent", "-keepAllNames", "-pad", "1"]]


@pytest.mark.parametrize("src", ["bed6", "bed6_sorted"])
@pytest.mark.parametrize("flags", BED_MERGE_FLAGS,
                         ids=[" ".join(f) or "default"
                              for f in BED_MERGE_FLAGS])
def test_bed_merge_byte_identical(files, tmp_path, src, flags):
    """bedMerge's records equal the JAX tool's, sorted and unsorted, with
    each flag; -lowMem on unsorted input merges in input order."""
    got = _both(tmp_path, "bedMerge",
                lambda d: [files[src], f"{d}/m.bed", *flags])
    assert got["m.bed"]


@pytest.mark.parametrize("src,flags", [("bed3", []), ("bed3", ["-lowMem"]),
                                       ("bed_empty", []),
                                       ("bed_empty", ["-lowMem"])])
def test_bed_merge_three_fields_and_empty(files, tmp_path, src, flags):
    """Three-field records, and an empty file, with and without -lowMem."""
    _both(tmp_path, "bedMerge", lambda d: [files[src], f"{d}/m.bed", *flags])


# (method, input, flags, a word of the exit or None)
BED_TO_WIG_CASES = [
    ("Reads", "points", [], None), ("Reads", "overlap", [], None),
    ("Name", "points", [], None), ("Score", "points", [], None),
    ("Annotation", "points", [], None),
    ("Annotation", "points", ["-annotationField", "1"], None),
    ("Name", "overlap", [], None),
    ("Name", "points", ["-useRange"], None),
    ("Score", "points", ["-useRange", "-defaultValue", "0"], None),
    ("Annotation", "points", ["-useRange", "-annotationField", "1"], None),
    ("Score", "points", ["-defaultValue", "-1"], None),
    ("Score", "clash", [], "share the same midpoint"),
    ("Score", "overlap", ["-useRange"], "overlapping bed elements"),
    ("Annotation", "points", ["-annotationField", "5"],
     "annotationField exceeds"),
    ("Bogus", "points", [], "Unrecognized method")]


@pytest.mark.parametrize("method,src,flags,exit_word", BED_TO_WIG_CASES,
                         ids=["-".join([m, s, *f]) for m, s, f, _ in
                              BED_TO_WIG_CASES])
def test_bed_to_wig_byte_identical(files, tmp_path, method, src, flags,
                                   exit_word):
    """bedToWig's wig, or its exit, equals the JAX tool's for each method
    and flag."""
    got = _both(tmp_path, "bedToWig", lambda d: [
        method, files[src], files["sizes"], f"{d}/o.wig", *flags])
    if exit_word:
        assert exit_word in got
    else:
        assert got["o.wig"].startswith(b"fixedStep chrom=chr1")


@pytest.mark.parametrize("query", ["query", "query_vcf"])
@pytest.mark.parametrize("rel", jinterval.RELATIONSHIPS)
def test_interval_overlap_relationships(files, tmp_path, query, rel):
    """intervalOverlap's lines equal the JAX tool's for every
    relationship, on bed and VCF queries; each has hits here."""
    got = _both(tmp_path, "intervalOverlap", lambda d: [
        files["select"], files[query], f"{d}/o", "-relationship", rel])
    assert got["o"]


INTERVAL_FLAGS = {
    "aggregate": ["-aggregate"],
    "non_overlap": ["-nonOverlap"],
    "merged_output": ["-mergedOutput", "-relationship", "within"],
    "merged_output_any": ["-mergedOutput"],
    "threshold": ["-thresholdOverlap", "0.5"],
    "threshold_merged": ["-thresholdOverlap", "0.9", "-mergedOutput",
                         "-aggregate"],
    "non_overlap_start": ["-nonOverlap", "-relationship", "start"],
}


@pytest.mark.parametrize("query", ["query", "query_vcf", "query_gz"])
@pytest.mark.parametrize("case", list(INTERVAL_FLAGS))
def test_interval_overlap_options(files, tmp_path, query, case):
    """-aggregate, -nonOverlap, -mergedOutput and -thresholdOverlap, on
    bed, VCF and gzipped bed queries."""
    got = _both(tmp_path, "intervalOverlap", lambda d: [
        files["select"], files[query], f"{d}/o", *INTERVAL_FLAGS[case]])
    assert got["o"]


def test_interval_overlap_vcf_select_and_gz_output(files, tmp_path):
    """VCF records as the selected set, and a gzipped output."""
    got = _both(tmp_path, "intervalOverlap", lambda d: [
        files["query_vcf"], files["query"], f"{d}/o.bed.gz",
        "-mergedOutput"])
    assert got["o.bed.gz"]


MERGESORT_INPUTS = {
    "bed": ("sort_bed", "o.bed"), "bed_gz": ("sort_bed_gz", "o.bed.gz"),
    "vcf": ("sort_vcf", "o.vcf"), "sam": ("sort_sam", "o.sam"),
    "bam": ("sort_bam", "o.sam"), "axt": ("sort_axt", "o.axt")}


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("fmt", list(MERGESORT_INPUTS))
def test_mergesort_byte_identical(files, tmp_path, fmt, chunk):
    """mergesort's output equals the JAX tool's for each format at chunk
    sizes 1, 7 and the default; the port leaves its -tmpDir empty."""
    src, out = MERGESORT_INPUTS[fmt]
    for side in ("jax", "port"):
        (tmp_path / f"{side}_tmp").mkdir()
    flags = [] if chunk is None else ["-numRecordsPerChunk", str(chunk)]
    got = _both(tmp_path, "mergesort", lambda d: [
        files[src], f"{d}/{out}", "-tmpDir", f"{d}_tmp", *flags])
    assert got[out]
    if fmt == "sam":  # unmapped '*' before chr1, the header as it was
        text = got[out].decode()
        body = [ln for ln in text.splitlines() if not ln.startswith("@")]
        assert body[0].split("\t")[2] == "*"
        assert "SO:unsorted" in text
    assert not os.listdir(tmp_path / "port_tmp")


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("src", ["sort_sam", "sort_bam"])
def test_mergesort_read_name(files, tmp_path, src, chunk):
    """-sortCriteria readName on SAM and BAM input: mates stay in input
    order."""
    flags = [] if chunk is None else ["-numRecordsPerChunk", str(chunk)]
    _both(tmp_path, "mergesort", lambda d: [
        files[src], f"{d}/o.sam", "-sortCriteria", "readName", *flags])


@pytest.mark.parametrize("chunk", [1, 7, None])
def test_mergesort_fastq_pair(files, tmp_path, chunk):
    """Comma-separated FASTQ pairs, each file sorted by name."""
    flags = [] if chunk is None else ["-numRecordsPerChunk", str(chunk)]
    got = _both(tmp_path, "mergesort", lambda d: [
        f"{files['fq1']},{files['fq2']}", f"{d}/o1.fq,{d}/o2.fq", *flags])
    assert got["o1.fq"].startswith(b"@read0 1:N:0\n")
    assert got["o2.fq"].startswith(b"@read0 2:N:0\n")


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("src", ["sort_sam", "sort_bam"])
def test_mergesort_bam_output(files, tmp_path, src, chunk):
    """A .bam output: its payload (compared by _both) and its records as
    the JAX reader reads them back equal the JAX tool's."""
    flags = [] if chunk is None else ["-numRecordsPerChunk", str(chunk)]
    got = _both(tmp_path, "mergesort", lambda d: [
        files[src], f"{d}/o.bam", *flags])
    assert got["o.bam"].startswith(b"BAM\x01")
    back = {}
    for side in ("jax", "port"):
        header, records = jsam.read(str(tmp_path / side / "o.bam"))
        back[side] = (header.text, [r.to_string() for r in records])
    assert back["port"] == back["jax"]
    assert len(back["port"][1]) == 45


def test_library_copies_equal_the_jax(files, monkeypatch):
    """The library copies the tools stand on, against the JAX's:
    from_string_forced on every byte value, aln_pos_to_ref_pos_counter
    over a multiFa record, go_fmt_g, native.compress_blocks, the BGZF
    writer on its zlib path, and IntervalIndex.query for each
    relationship."""
    raw = bytes(range(1, 128)) + b"acgtnACGTNxyzXYZ"
    assert np.array_equal(dna.from_string_forced(raw),
                          jdna.from_string_forced(raw))
    rec = fasta.read(files["multi_fa"])[0]
    jrec = jfasta.read(files["multi_fa"])[0]
    for args in ((0, 0, 0), (37, 10, 20), (150, 0, 0), (5, 3, 40)):
        assert (fasta.aln_pos_to_ref_pos_counter(rec, *args)
                == jfasta.aln_pos_to_ref_pos_counter(jrec, *args))
    for x in (0.0, -0.0, 1.0, 0.1, 1e20, 3.25e-05, 1e-7, 123456789.0,
              float("nan"), float("inf"), -float("inf"), 1.7976931348623157e308):
        assert wig.go_fmt_g(x) == jwig.go_fmt_g(x)
    data = np.random.default_rng(7).integers(0, 4, 300_000).astype(
        np.uint8).tobytes()
    for bgzf in (True, False):
        ours = native.compress_blocks(data, bgzf=bgzf, nthreads=3)
        assert ours == jnative.compress_blocks(data, bgzf=bgzf, nthreads=3)
        assert gzip.decompress(ours) == data
    header, records = sam.read(files["sort_sam"])
    jheader, jrecords = jsam.read(files["sort_sam"])
    out = {}
    for side, mod, h, r in (("jax", jbam_writer, jheader, jrecords),
                            ("port", bam_writer, header, records)):
        path = os.path.join(os.path.dirname(files["sort_sam"]),
                            f"zlib_{side}.bam")
        if side == "port":
            monkeypatch.setattr(native, "compress_blocks",
                                lambda *a, **k: None)
        mod.write_bam(path, h, r)
        out[side] = _content(path)
    assert out["port"] == out["jax"]
    sel = interval.read_intervals(files["select"])
    jsel = jinterval.read_intervals(files["select"])
    index, jindex = interval.IntervalIndex(sel), jinterval.IntervalIndex(jsel)
    queries = interval.read_intervals(files["query_vcf"])
    jqueries = jinterval.read_intervals(files["query_vcf"])
    for rel in interval.RELATIONSHIPS:
        for q, jq in zip(queries, jqueries):
            assert ([interval.record_to_string(a) for a in index.query(q, rel)]
                    == [jinterval.record_to_string(a)
                        for a in jindex.query(jq, rel)])
