"""The port's GTF tools (``gtfTools``, ``getPromoter``, ``geneIdToName``,
``scCount``, ``quickOrthologs``; gonomics_tpu_torch/cli/) on the CPU
against the JAX tools: the bytes of every file they write, their stdout,
and the message of every exit, on inputs that a numpy seed builds here: a
GTF of genes on chr1, chr2 and chrU (a chrom no chain covers), each of
1-3 transcripts of 1-6 exons on either strand, two thirds of them with
CDS lines of frames 0-2, some with 5UTR and 3UTR lines, gene, start_codon
and stop_codon lines, dot and numeric scores, empty and shared gene
names; a barcoded SAM over those genes; a chain file with a plus and a
minus query chain, two of them overlapping on chr2. Each quirk of the
reference that the port keeps is pinned by a case here. Also the library
under them: every public name of ``io/gtf.py`` against the JAX's (the
masks as arrays, the beds as text, the genes as nested tuples with the
CDS chain as indices), and the interval properties of the port's ``Sam``.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from gonomics_tpu.cli import gene_id_to_name as jgene_id_to_name
from gonomics_tpu.cli import get_promoter as jget_promoter
from gonomics_tpu.cli import gtf_tools as jgtf_tools
from gonomics_tpu.cli import quick_orthologs as jquick_orthologs
from gonomics_tpu.cli import sc_count as jsc_count
from gonomics_tpu.io import chrom_info as jchrom_info
from gonomics_tpu.io import gtf as jgtf
from gonomics_tpu.io import sam as jsam
from gonomics_tpu_torch.cli import (gene_id_to_name, get_promoter, gtf_tools,
                                    quick_orthologs, sc_count)
from gonomics_tpu_torch.io import chrom_info, gtf, sam

TOOLS = {"gtfTools": (jgtf_tools.main, gtf_tools.main),
         "getPromoter": (jget_promoter.main, get_promoter.main),
         "geneIdToName": (jgene_id_to_name.main, gene_id_to_name.main),
         "scCount": (jsc_count.main, sc_count.main),
         "quickOrthologs": (jquick_orthologs.main, quick_orthologs.main)}

SIZES = [("chr1", 40_000), ("chr2", 16_000), ("chrU", 6_000)]
BARCODES = ["AACC", "AAGT", "CCAT", "GGTA", "TTAC"]


def _both(tmp_path, tool: str, argv) -> dict:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits, stdout and the files they
    wrote under d equal; returns the port's {"exit": message or None,
    "stdout": text, "files": {name: bytes}}."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                main(argv(str(d)))
            exit_msg = None
        except SystemExit as e:
            exit_msg = str(e)
        except Exception as e:  # the reference's KeyError, ...
            exit_msg = f"{type(e).__name__}: {e}"
        files = {}
        for n in sorted(os.listdir(d)):
            with open(os.path.join(d, n), "rb") as f:
                files[n] = f.read()
        seen[side] = {"exit": exit_msg, "stdout": buf.getvalue(),
                      "files": files}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _write(path, lines) -> str:
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in lines)
    return str(path)


def _lines(got: dict, name: str) -> list[str]:
    return got["files"][name].decode().splitlines()


# --- inputs


def _attrs(**kv) -> str:
    return " ".join(f'{k} "{v}";' for k, v in kv.items())


def _row(chrom, feature, start, end, score, strand, frame, attrs) -> str:
    return "\t".join([chrom, "test", feature, str(start), str(end), score,
                      strand, frame, attrs])


def _score(rng) -> str:
    return "." if rng.random() < 0.85 else f"{int(rng.integers(0, 400)) / 4}"


def _gene_lines(rng, chrom: str, gid: str, name: str, start: int,
                end: int) -> list[str]:
    """A gene line, then 1-3 transcripts of 1-6 exons inside [start,
    end] (1-based, closed) on one strand; two thirds of the genes carry
    CDS lines of frames 0-2 on every exon past a 5UTR, some with 5UTR and
    3UTR lines, start_codon and stop_codon lines."""
    strand = "+" if rng.random() < 0.5 else "-"
    coding = rng.random() < 2 / 3
    out = [_row(chrom, "gene", start, end, ".", strand, ".",
                _attrs(gene_id=gid, gene_name=name))]
    for t in range(int(rng.integers(1, 4))):
        tid = f"{gid}.{t + 1}"
        ne = int(rng.integers(1, 7))
        pts = np.sort(rng.choice(np.arange(start, end + 1), 2 * ne,
                                 replace=False)).tolist()
        exons = [(pts[2 * i], pts[2 * i + 1]) for i in range(ne)]
        out.append(_row(chrom, "transcript", exons[0][0], exons[-1][1],
                        _score(rng), strand, ".",
                        _attrs(gene_id=gid, transcript_id=tid,
                               gene_name=name)))
        utr5 = coding and rng.random() < 0.5
        utr3 = coding and rng.random() < 0.5
        for i, (s, e) in enumerate(exons):
            att = _attrs(gene_id=gid, transcript_id=tid,
                         exon_number=str(i + 1), exon_id=f"{tid}.e{i + 1}",
                         gene_name=name)
            out.append(_row(chrom, "exon", s, e, _score(rng), strand, ".",
                            att))
            if not coding:
                continue
            cs, ce = s, e
            if i == 0 and utr5 and e - s >= 4:
                cut = int(rng.integers(s + 1, e))
                out.append(_row(chrom, "5UTR", s, cut - 1, ".", strand, ".",
                                att))
                cs = cut
            if i == ne - 1 and utr3 and ce - cs >= 4:
                cut = int(rng.integers(cs + 1, ce))
                out.append(_row(chrom, "CDS", cs, cut, _score(rng), strand,
                                str(int(rng.integers(0, 3))), att))
                out.append(_row(chrom, "3UTR", cut + 1, ce, ".", strand, ".",
                                att))
            else:
                out.append(_row(chrom, "CDS", cs, ce, _score(rng), strand,
                                str(int(rng.integers(0, 3))), att))
            if i == 0:
                out.append(_row(chrom, "start_codon", cs, min(cs + 2, ce),
                                ".", strand, "0", att))
            if i == ne - 1:
                out.append(_row(chrom, "stop_codon", max(ce - 2, cs), ce,
                                ".", strand, "0", att))
    return out


def _gtf(rng, genes_per_chrom: dict) -> tuple[list[str], list[tuple]]:
    """GTF lines of non-overlapping genes at least 600 bases apart, and
    (gene_id, name, chrom, start, end) of each. About one in ten has an
    empty name; some share a name; one's name holds a space."""
    lines, genes, k = ["#!genome-build test"], [], 0
    for chrom, size in SIZES:
        p = 300
        for _ in range(genes_per_chrom[chrom]):
            length = int(rng.integers(200, 1400))
            if p + length > size - 300:
                break
            gid = f"G{k:03d}"
            r = rng.random()
            name = ("" if r < 0.1 else f"N{k // 2:03d}" if r < 0.25
                    else "Two Words" if k == 7 else f"N{k:03d}")
            lines += _gene_lines(rng, chrom, gid, name, p, p + length)
            genes.append((gid, name, chrom, p, p + length))
            p += length + 600 + int(rng.integers(0, 500))
            k += 1
    return lines, genes


def _chain_text(score, t, t_size, t_strand, t0, t1, q, q_size, q_strand,
                q0, q1, cid, blocks) -> str:
    body = "\n".join(f"{s}\t{tb}\t{qb}" for s, tb, qb in blocks[:-1])
    return (f"chain {score} {t} {t_size} {t_strand} {t0} {t1} {q} {q_size} "
            f"{q_strand} {q0} {q1} {cid}\n" + body
            + ("\n" if body else "") + f"{blocks[-1][0]}\n\n")


def _sam_lines(rng, genes, n: int, no_overlap: int) -> list[str]:
    """A barcoded SAM: n reads drawn over the genes' first-transcript
    spans and no_overlap reads between genes or unmapped, each named
    r<i>_BX:<barcode>_UMI:<umi>, with M, I, D and N in the CIGARs, sorted
    by barcode (stably)."""
    head = ["@HD\tVN:1.6\tSO:unsorted"] + [f"@SQ\tSN:{c}\tLN:{s}"
                                          for c, s in SIZES]
    rows = []
    for i in range(n + no_overlap):
        bx = BARCODES[int(rng.integers(0, len(BARCODES)))]
        umi = "".join(rng.choice(list("ACGT"), 6))
        qname = f"r{i}_BX:{bx}_UMI:{umi}"
        if i >= n and i % 3 == 0:
            rows.append((bx, f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*"))
            continue
        if i < n:
            _, _, chrom, s, e = genes[int(rng.integers(0, len(genes)))]
            pos = int(rng.integers(s - 60, e + 10))
        else:  # in the 600 bases after a gene
            _, _, chrom, s, e = genes[int(rng.integers(0, len(genes)))]
            pos = e + 120 + int(rng.integers(0, 300))
        a, b = int(rng.integers(10, 40)), int(rng.integers(10, 40))
        kind = int(rng.integers(0, 4))
        cigar, qlen = [(f"{a + b}M", a + b), (f"{a}M2I{b}M", a + b + 2),
                       (f"{a}M3D{b}M", a + b), (f"{a}M40N{b}M", a + b)][kind]
        seq = "".join(rng.choice(list("ACGT"), qlen))
        flag = 16 if rng.random() < 0.5 else 0
        rows.append((bx, f"{qname}\t{flag}\t{chrom}\t{max(pos, 1)}\t60\t"
                         f"{cigar}\t*\t0\t0\t{seq}\t*"))
    rows.sort(key=lambda r: r[0])
    return head + [r for _, r in rows]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gtf_tools")
    rng = np.random.default_rng(3100)
    lines, genes = _gtf(rng, {"chr1": 22, "chr2": 9, "chrU": 3})
    f = {"genes": genes}
    f["gtf"] = _write(tmp / "genes.gtf", lines)
    f["sizes"] = _write(tmp / "ga.sizes", [f"{c}\t{s}" for c, s in SIZES])
    names = [g[1] for g in genes if g[1]]
    f["names"] = _write(tmp / "names.txt",
                        names[::3] + [names[1], "NoSuchGene", "Two Words"])
    f["names_chr1"] = _write(tmp / "names_chr1.txt",
                             [g[1] for g in genes if g[2] == "chr1"][:4])
    ids = [g[0] for g in genes]
    f["table"] = _write(tmp / "table.tsv",
                        [f"{g}\tsym_{g}" for g in ids[::2]] + ["N000\tname0"])
    # a TSS-like tab file named by gene id, one line with two ids
    tss = [f"{c}\t{s - 1}\t{s}\t{g}" for g, _, c, s, _ in genes]
    tss.append(f"chr1\t5\t6\t{ids[0]}\t{ids[2]}")
    tss.append("chr1\t7\t8\tnot_an_id")
    f["tss_ids"] = _write(tmp / "tss_ids.txt", tss)
    f["sam"] = _write(tmp / "bx.sam", _sam_lines(rng, genes, 160, 30))
    on = [g[0] for g in genes if rng.random() < 1 / 3]
    f["norm"] = _write(tmp / "norm.tsv",
                       [f"{g}\t{rng.uniform(0.1, 3):.6f}" for g in on])
    f["norm_bad"] = _write(tmp / "norm_bad.tsv", [f"{ids[0]}\t1.5\textra"])
    # chr1 through one plus chain with gaps; chr2 through a plus chain over
    # [0, 10000) and a minus chain over [6000, 16000): TSSs in [6000,
    # 10000) fall under both; chrU under none
    f["chain"] = _write(tmp / "t_q.chain", [
        _chain_text(100, "chr1", 40_000, "+", 0, 40_000, "q1", 40_100, "+",
                    0, 40_100, 1, [(12_000, 0, 40), (15_000, 30, 90),
                                   (12_970, 0, 0)]),
        _chain_text(90, "chr2", 16_000, "+", 0, 10_000, "q2", 10_500, "+", 0,
                    10_000, 2, [(4000, 20, 20), (5980, 0, 0)]),
        _chain_text(80, "chr2", 16_000, "+", 6000, 16_000, "q3", 12_000, "-",
                    1000, 11_000, 3, [(10_000, 0, 0)])])
    return f


def _ids(lines) -> list[str]:
    out = []
    for ln in lines:
        gid = ln.split("\t")[8].split('"')[1]
        if not out or out[-1] != gid:
            out.append(gid)
    return out


# --- gtfTools


FILTER_CASES = {
    "coding": ["-codingTranscript"],
    "chrom": ["-chromFilter", "chr2"],
    "names": ["-geneNameList", "{names}"],
    "names_and_chrom": ["-geneNameList", "{names_chr1}", "-chromFilter",
                        "chr2"],
    "all_three": ["-geneNameList", "{names}", "-chromFilter", "chr1",
                  "-codingTranscript"],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_gtf_tools_filter(files, tmp_path, case):
    """filter writes the genes that pass, transcript, exon, 5UTR, CDS and
    3UTR lines of each (no codon or gene lines); with both a name list and
    a chrom, a listed gene passes whatever its chrom and an unlisted one
    where all its transcripts lie on the chrom."""
    flags = [a.format(**files) for a in FILTER_CASES[case]]
    got = _both(tmp_path, "gtfTools", lambda d: [
        "filter", files["gtf"], d + "/out.gtf", *flags])
    assert got["exit"] is None
    lines = _lines(got, "out.gtf")
    assert lines
    feats = {ln.split("\t")[2] for ln in lines}
    assert feats <= {"transcript", "exon", "5UTR", "CDS", "3UTR"}
    if case == "names_and_chrom":
        listed = set(open(files["names_chr1"]).read().split("\n")) - {""}
        want = [g for g, n, c, _, _ in files["genes"]
                if n in listed or c == "chr2"]
        assert _ids(lines) == want
        assert any(c == "chr1" for g, _, c, _, _ in files["genes"]
                   if g in want)


TO_BED_CASES = {
    "plain": [],
    "tss": ["-tss", "-chromSizeFile", "{sizes}"],
    "tss_merge": ["-tss", "-chromSizeFile", "{sizes}", "-merge"],
    "codons": ["-firstTwoCodonBases"],
    "tss_no_sizes": ["-tss"],
    "tss_and_codons": ["-tss", "-chromSizeFile", "{sizes}",
                       "-firstTwoCodonBases"],
}


@pytest.mark.parametrize("case", sorted(TO_BED_CASES))
def test_gtf_tools_to_bed(files, tmp_path, case):
    """toBed: plain, one 6-field bed a non-comment line named source:
    feature then every field from the score on joined with ':'; -tss one
    base a transcript (merged with -merge); -firstTwoCodonBases sorted;
    -tss without sizes, or with -firstTwoCodonBases, exits."""
    flags = [a.format(**files) for a in TO_BED_CASES[case]]
    got = _both(tmp_path, "gtfTools", lambda d: [
        "toBed", files["gtf"], d + "/out.bed", *flags])
    if case == "tss_no_sizes":
        assert got["exit"] == ("Error: user must specify a chromSizes file "
                               "to convert to a Tss bed.")
        return
    if case == "tss_and_codons":
        assert got["exit"] == ("Error: user cannot specify both tss and "
                               "firstTwoBasesOfCodons.")
        return
    assert got["exit"] is None
    lines = _lines(got, "out.bed")
    if case == "plain":
        src = [ln for ln in open(files["gtf"]).read().splitlines()
               if not ln.startswith("#")]
        assert len(lines) == len(src)
        w, b = src[0].split("\t"), lines[0].split("\t")
        assert b == [w[0], str(int(w[3]) - 1), w[4],
                     ":".join([w[1], w[2]] + w[5:]), "0", w[6]]
    if case == "tss":
        assert all(int(ln.split("\t")[2]) - int(ln.split("\t")[1]) == 1
                   for ln in lines)


@pytest.mark.parametrize("argv", [[], ["toBedd", "a", "b"]])
def test_gtf_tools_subcommand_exits(tmp_path, argv):
    """A missing or unknown subcommand exits with the reference's
    message."""
    got = _both(tmp_path, "gtfTools", lambda d: argv)
    assert got["exit"] == ("Error: user must specify a gtfTools subcommand."
                           if not argv else
                           "Error: unrecognized subcommand: toBedd.")


# --- getPromoter


@pytest.mark.parametrize("flags", [[], ["-upstream", "300", "-downstream",
                                        "50"],
                                   ["-upstream", "5000", "-downstream",
                                    "9000"]])
def test_get_promoter(files, tmp_path, flags):
    """A window a transcript of every gene of each listed name, a name
    listed twice twice; on the minus strand around the transcript's start
    (not its end); clipped at 0 and at the chrom's size."""
    got = _both(tmp_path, "getPromoter", lambda d: [
        files["names"], files["gtf"], d + "/p.bed", files["sizes"], *flags])
    assert got["exit"] is None
    lines = _lines(got, "p.bed")
    assert lines
    up = int(flags[1]) if flags else 1000
    down = int(flags[3]) if flags else 200
    tx = {}
    for ln in open(files["gtf"]):
        w = ln.rstrip("\n").split("\t")
        if len(w) > 2 and w[2] == "transcript":
            name = w[8].split('gene_name "')[1].split('"')[0]
            tx.setdefault(name, []).append((w[0], int(w[3]), w[6]))
    sizes = dict(SIZES)
    want = []
    for name in open(files["names"]).read().split("\n")[:-1]:
        for c, s, strand in tx.get(name, []):
            lo, hi = (up, down + 1) if strand == "+" else (down, up + 1)
            want.append(f"{c}\t{max(s - lo, 0)}\t{min(s + hi, sizes[c])}\t"
                        f"{name}")
    assert lines == want


# --- geneIdToName


@pytest.mark.parametrize("keep", [False, True])
def test_gene_id_to_name(files, tmp_path, keep):
    """Every column that matches is replaced and counts once as lifted;
    a line with none counts once as not found, dropped with
    -keepMatching; the counts printed after the file."""
    got = _both(tmp_path, "geneIdToName", lambda d: [
        files["table"], files["tss_ids"], d + "/o.txt"]
        + (["-keepMatching"] if keep else []))
    assert got["exit"] is None
    table = dict(ln.split("\t") for ln in
                 open(files["table"]).read().splitlines())
    src = open(files["tss_ids"]).read().splitlines()
    lifted = sum(c in table for ln in src for c in ln.split("\t"))
    missed = sum(not any(c in table for c in ln.split("\t")) for ln in src)
    assert got["stdout"] == (f"geneIDs lifted: {lifted}\n"
                             f"geneIDs not found: {missed}\n")
    lines = _lines(got, "o.txt")
    assert len(lines) == len(src) - (missed if keep else 0)
    assert "chr1\t5\t6\tsym_G000\tsym_G002" in lines


@pytest.mark.parametrize("flag", ["-ncbi", "-ensembl"])
def test_gene_id_to_name_presets_exit(files, tmp_path, flag):
    got = _both(tmp_path, "geneIdToName", lambda d: [
        files["table"], files["tss_ids"], d + "/o.txt", flag])
    assert got["exit"] == ("preset NCBI/ENSEMBL tables are not bundled; "
                           "supply a conversion table")
    assert got["files"] == {}


# --- scCount


@pytest.mark.parametrize("norm", [False, True])
def test_sc_count(files, tmp_path, norm):
    """A header of the gene ids in sorted order, then a row a barcode
    among the reads that overlap a gene's first transcript, counts in
    Go's %g (times the normalisation value with -expNormalizationFile)."""
    got = _both(tmp_path, "scCount", lambda d: [
        files["sam"], files["gtf"], d + "/m.tsv"]
        + (["-expNormalizationFile", files["norm"]] if norm else []))
    assert got["exit"] is None
    lines = _lines(got, "m.tsv")
    ids = sorted(g[0] for g in files["genes"])
    assert lines[0] == "Bx\t" + "\t".join(ids)
    assert [ln.split("\t")[0] for ln in lines[1:]] == BARCODES
    if not norm:
        total = sum(float(x) for ln in lines[1:] for x in ln.split("\t")[1:])
        assert total > 100


def _sam_case(files, tmp_path, rows) -> str:
    head = open(files["sam"]).read().splitlines()[:1 + len(SIZES)]
    return _write(tmp_path / "case.sam", head + rows)


SC_CASES = {
    # a read with no BX: exits though it overlaps no gene
    "no_bx": ["r1_UMI:AAAA\t0\tchr1\t5\t60\t10M\t*\t0\t0\tACGTACGTAC\t*"],
    "no_umi": ["r1_BX:AC\t0\tchr1\t5\t60\t10M\t*\t0\t0\tACGTACGTAC\t*"],
    # no read overlaps a gene: the header, then a line of one tab
    "no_overlap": ["r1_BX:AC_UMI:AA\t0\tchr1\t5\t60\t10M\t*\t0\t0\t"
                   "ACGTACGTAC\t*",
                   "r2_BX:AC_UMI:AA\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*"],
    # the barcode changes between overlapping reads only: two rows
    "barcode_runs": ["r1_BX:B1_UMI:AA\t0\t{c}\t{s}\t60\t10M\t*\t0\t0\t"
                     "ACGTACGTAC\t*",
                     "r2_BX:B2_UMI:AA\t0\tchr1\t5\t60\t10M\t*\t0\t0\t"
                     "ACGTACGTAC\t*",
                     "r3_BX:B1_UMI:AA\t0\t{c}\t{s}\t60\t5M2D5M\t*\t0\t0\t"
                     "ACGTACGTAC\t*",
                     "r4_BX:B3_UMI:AA\t16\t{c}\t{s}\t60\t10M\t*\t0\t0\t"
                     "ACGTACGTAC\t*"],
}


@pytest.mark.parametrize("case", sorted(SC_CASES))
def test_sc_count_quirks(files, tmp_path, case):
    """A read's barcode and UMI are parsed before its overlap; with no
    overlap the matrix is one tab; a read of another barcode that
    overlaps no gene starts no row (B1, B2 off the genes, B1, B3 give
    rows B1 and B3)."""
    t = next(iter(gtf.read(files["gtf"]).values())).transcripts[0]
    rows = [r.format(c=t.chrom, s=t.start + 3) for r in SC_CASES[case]]
    path = _sam_case(files, tmp_path, rows)
    got = _both(tmp_path, "scCount", lambda d: [path, files["gtf"],
                                                d + "/m.tsv"])
    if case == "no_bx":
        assert got["exit"] == ("Failed to parse Barcode from single-cell "
                               "read name.")
    elif case == "no_umi":
        assert got["exit"] == "Failed to parse Umi from single-cell read name."
    elif case == "no_overlap":
        assert got["exit"] is None
        assert _lines(got, "m.tsv")[1:] == ["\t"]
    else:
        lines = _lines(got, "m.tsv")
        assert [ln.split("\t")[0] for ln in lines[1:]] == ["B1", "B3"]
        assert sorted(float(x) for ln in lines[1:]
                      for x in ln.split("\t")[1:] if x != "0") == [1.0, 2.0]


def test_sc_count_two_genes_exit(files, tmp_path):
    """A read over two genes exits with its SAM line."""
    g = _write(tmp_path / "two.gtf", [
        _row("chr1", "transcript", 100, 200, ".", "+", ".",
             _attrs(gene_id="A", transcript_id="A.1", gene_name="a")),
        _row("chr1", "exon", 100, 200, ".", "+", ".",
             _attrs(gene_id="A", transcript_id="A.1", exon_number="1",
                    exon_id="e1")),
        _row("chr1", "transcript", 210, 300, ".", "-", ".",
             _attrs(gene_id="B", transcript_id="B.1", gene_name="b"))])
    row = ("r1_BX:B1_UMI:AA\t0\tchr1\t195\t60\t20M\t*\t0\t0\t" + "A" * 20
           + "\t*")
    path = _sam_case(files, tmp_path, [row])
    got = _both(tmp_path, "scCount", lambda d: [path, g, d + "/m.tsv"])
    assert got["exit"] == ("The following input SAM record maps to multiple "
                           f"genes in the gtf file:\n{row}.")


def test_sc_count_norm_file_exits(files, tmp_path):
    got = _both(tmp_path, "scCount", lambda d: [
        files["sam"], files["gtf"], d + "/m.tsv", "-expNormalizationFile",
        files["norm_bad"]])
    assert got["exit"] == ("Expression normalization input file must be a "
                           "tab-separated file with two columns per line.")


# --- quickOrthologs


@pytest.mark.parametrize("canonical", [False, True])
def test_quick_orthologs(files, tmp_path, canonical):
    """Each named TSS lifted by the one chain over it, in the genes'
    order; one under two chains or none to the unmapped file after its
    message; a TSS of an empty name in neither."""
    got = _both(tmp_path, "quickOrthologs", lambda d: (
        ["--canonicalTranscript"] if canonical else []) + [
        "t", "q", files["gtf"], files["chain"], files["sizes"],
        d + "/o.tsv", d + "/un.txt"])
    assert got["exit"] is None
    out, un = _lines(got, "o.tsv"), _lines(got, "un.txt")
    assert out[0].startswith("#geneName\ttName")
    assert all(ln.split("\t")[0] for ln in out[1:])
    msgs = un[0::2]
    assert "Record below has no ortholog in new assembly:" in msgs
    assert "Record below maps to multiple chains:" in msgs
    assert all(ln.split("\t")[0] == "chrU" for m, ln in zip(un[0::2],
                                                            un[1::2])
               if m.startswith("Record below has no"))
    assert all(ln.split("\t")[3] for ln in un[1::2])
    named = {g[0] for g in files["genes"] if g[1]}
    assert len(named) < len(files["genes"])


def test_quick_orthologs_single_dash_refused(files, tmp_path):
    """--canonicalTranscript takes two dashes: one dash is refused by
    both parsers alike."""
    got = _both(tmp_path, "quickOrthologs", lambda d: [
        "-canonicalTranscript", "t", "q", files["gtf"], files["chain"],
        files["sizes"], d + "/o.tsv", d + "/un.txt"])
    assert got["exit"] == "2"


# --- io/gtf.py quirks, through the tools


def _tiny(tmp_path, rows) -> str:
    return _write(tmp_path / "tiny.gtf", rows)


T_ATT = _attrs(gene_id="G", transcript_id="T", gene_name="g")
E_ATT = _attrs(gene_id="G", transcript_id="T", exon_number="1",
               exon_id="E1")
READ_CASES = {
    "ten_fields": [_row("chr1", "transcript", 10, 90, ".", "+", ".", T_ATT)
                   + "\textra"],
    "eleven_fields": [_row("chr1", "transcript", 10, 90, ".", "+", ".",
                           T_ATT) + "\textra\tmore"],
    "frame_dot_and_scores": [
        _row("chr1", "transcript", 10, 90, "7.25", "-", ".", T_ATT),
        _row("chr1", "exon", 10, 90, ".", "-", ".", E_ATT),
        _row("chr1", "CDS", 20, 80, "3", "-", ".", E_ATT)],
    "frame_three": [
        _row("chr1", "transcript", 10, 90, ".", "+", ".", T_ATT),
        _row("chr1", "exon", 10, 90, ".", "+", ".", E_ATT),
        _row("chr1", "CDS", 20, 80, ".", "+", "3", E_ATT)],
    "cds_without_exon": [
        _row("chr1", "transcript", 10, 90, ".", "+", ".", T_ATT),
        _row("chr1", "CDS", 20, 80, ".", "+", "0", E_ATT)],
    # the second exon of id E1 takes no CDS or UTR: the first does
    "repeated_exon_id": [
        _row("chr1", "transcript", 10, 90, ".", "+", ".", T_ATT),
        _row("chr1", "exon", 10, 30, ".", "+", ".", E_ATT),
        _row("chr1", "exon", 50, 90, ".", "+", ".", E_ATT),
        _row("chr1", "3UTR", 60, 90, ".", "+", ".", E_ATT),
        _row("chr1", "CDS", 50, 59, ".", "+", "1", E_ATT),
        _row("chr1", "5UTR", 50, 52, ".", "+", ".", E_ATT)],
    # the attribute value is cut at its first space only
    "spaced_values": [
        _row("chr1", "transcript", 10, 90, ".", "+", ".",
             'gene_id "G";  transcript_id "T x";gene_name "a b c"; x'),
        _row("chr1", "exon", 10, 90, ".", "+", ".",
             'gene_id "G"; transcript_id "T x"; exon_id "E 1";')],
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_gtf_read_quirks_through_filter(tmp_path, case):
    """gtf.read's quirks through gtfTools filter: a line of 10 tab fields
    read, one of 11 refused with the message that says nine; frame '.'
    as -1 (written back as -1), a frame above 2 exits; a score '.' as -1
    and written '.', others written %f; a CDS without its exon a
    KeyError; a repeated exon id binds CDS and UTRs to its first exon,
    written exon, 5UTR, CDS, 3UTR; values cut at the first space."""
    path = _tiny(tmp_path, READ_CASES[case])
    got = _both(tmp_path, "gtfTools", lambda d: ["filter", path,
                                                 d + "/o.gtf"])
    if case == "eleven_fields":
        assert got["exit"] == ("The GTF file format is limited to nine "
                               "fields. Line had 11 fields.")
    elif case == "frame_three":
        assert got["exit"] == ("Frame for GTF entries must be either dot, 0,"
                               " 1, or 2.")
    elif case == "cds_without_exon":
        assert got["exit"] == "KeyError: ('T', 'E1')"
    else:
        assert got["exit"] is None
        lines = _lines(got, "o.gtf")
        if case == "frame_dot_and_scores":
            assert lines[0].split("\t")[5] == "7.250000"
            assert lines[1].split("\t")[5] == "."
            assert lines[2].split("\t")[5:8] == ["3.000000", "-", "-1"]
        if case == "repeated_exon_id":
            assert [ln.split("\t")[2] for ln in lines] == [
                "transcript", "exon", "5UTR", "CDS", "3UTR", "exon"]
        if case == "spaced_values":
            assert 'transcript_id "T x"' in lines[0]
            assert 'gene_name "a b c"' in lines[0]
            assert 'exon_id "E 1"' in lines[1]


def test_gtf_tss_canonical_strictly_longer(tmp_path):
    """--canonicalTranscript: a transcript takes slot 0 only where it is
    strictly longer (CDS, then cDNA); equal ones leave the first."""
    rows = []
    for gid, specs in (("EQ", [(100, 200, 120, 180), (300, 400, 320, 380)]),
                       ("CD", [(100, 150, 110, 140), (300, 500, 310, 340)]),
                       ("CS", [(100, 400, None, None), (500, 560, 510, 520)])):
        for t, (s, e, cs, ce) in enumerate(specs):
            tid = f"{gid}.{t}"
            ta = _attrs(gene_id=gid, transcript_id=tid, gene_name=gid)
            ea = _attrs(gene_id=gid, transcript_id=tid, exon_number="1",
                        exon_id=f"{tid}.e")
            rows += [_row("chr1", "transcript", s, e, ".", "+", ".", ta),
                     _row("chr1", "exon", s, e, ".", "+", ".", ea)]
            if cs is not None:
                rows.append(_row("chr1", "CDS", cs, ce, ".", "+", "0", ea))
    path = _tiny(tmp_path, rows)
    sizes = _write(tmp_path / "s.sizes", ["chr1\t1000"])
    chain = _write(tmp_path / "c.chain", [_chain_text(
        1, "chr1", 1000, "+", 0, 1000, "q", 1000, "+", 0, 1000, 1,
        [(1000, 0, 0)])])
    got = _both(tmp_path, "quickOrthologs", lambda d: [
        "--canonicalTranscript", "t", "q", path, chain, sizes,
        d + "/o.tsv", d + "/un.txt"])
    starts = {ln.split("\t")[0]: int(ln.split("\t")[3])
              for ln in _lines(got, "o.tsv")[1:]}
    # EQ: equal CDS and cDNA, the first stays; CD: equal CDS (31), the
    # longer cDNA second; CS: the second has the only CDS
    assert starts == {"EQ": 99, "CD": 299, "CS": 499}


# --- the library against the JAX's


def _gene_tuple(g) -> tuple:
    cds_all = [e.cds for t in g.transcripts for e in t.exons if e.cds]
    index = {id(c): i for i, c in enumerate(cds_all)}

    def link(c):
        return None if c is None else index.get(id(c), "outside")

    def feat(x):
        return None if x is None else (x.start, x.end, x.score)

    return (g.gene_id, g.gene_name, g.chrom, g.chrom_start, g.chrom_end,
            tuple((t.chrom, t.source, t.start, t.end, t.score, t.strand,
                   t.transcript_id,
                   tuple((e.start, e.end, e.score, e.exon_number, e.exon_id,
                          None if e.cds is None else
                          (e.cds.start, e.cds.end, e.cds.score, e.cds.frame,
                           link(e.cds.prev), link(e.cds.next)),
                          feat(e.five_utr), feat(e.three_utr))
                         for e in t.exons))
                  for t in g.transcripts))


def _genes(mod, path) -> dict:
    return mod.read(path)


def _beds(recs) -> list[str]:
    return [b.to_string() for b in recs]


def test_gtf_public_names_defined():
    """Every public name of the JAX's io/gtf.py is defined in the port's
    copy; the port's Sam has the interval properties."""
    own = [n for n, v in vars(jgtf).items()
           if not n.startswith("_")
           and getattr(v, "__module__", None) == jgtf.__name__]
    assert len(own) == 24
    assert all(getattr(gtf, n).__module__ == gtf.__name__ for n in own)
    for p in ("chrom", "chrom_start", "chrom_end"):
        assert isinstance(getattr(sam.Sam, p), property)


def test_gtf_read_and_write_equal_jax(files, tmp_path):
    j, p = _genes(jgtf, files["gtf"]), _genes(gtf, files["gtf"])
    assert list(p) == list(j)
    assert [_gene_tuple(g) for g in p.values()] == [
        _gene_tuple(g) for g in j.values()]
    jgtf.write(str(tmp_path / "j.gtf"), j)
    gtf.write(str(tmp_path / "p.gtf"), p)
    assert ((tmp_path / "p.gtf").read_bytes()
            == (tmp_path / "j.gtf").read_bytes())
    for jg, pg in zip(j.values(), p.values()):
        for jt, pt in zip(jg.transcripts, pg.transcripts):
            assert gtf.cdna_length(pt) == jgtf.cdna_length(jt)
            assert gtf.cds_length(pt) == jgtf.cds_length(jt)


def test_gtf_cds_chain_resets_only_at_transcript(tmp_path):
    """Two transcript lines before their exons: the first transcript's
    CDS links on to the second's."""
    a = _attrs(gene_id="G", transcript_id="A", gene_name="g")
    b = _attrs(gene_id="G", transcript_id="B", gene_name="g")
    ea = _attrs(gene_id="G", transcript_id="A", exon_id="e")
    eb = _attrs(gene_id="G", transcript_id="B", exon_id="e")
    path = _tiny(tmp_path, [
        _row("chr1", "transcript", 10, 90, ".", "+", ".", a),
        _row("chr1", "transcript", 10, 90, ".", "+", ".", b),
        _row("chr1", "exon", 10, 50, ".", "+", ".", ea),
        _row("chr1", "CDS", 20, 50, ".", "+", "0", ea),
        _row("chr1", "exon", 60, 90, ".", "+", ".", eb),
        _row("chr1", "CDS", 60, 80, ".", "+", "2", eb)])
    j, p = _genes(jgtf, path)["G"], _genes(gtf, path)["G"]
    assert _gene_tuple(p) == _gene_tuple(j)
    assert p.transcripts[0].exons[0].cds.next is p.transcripts[1].exons[0].cds


def test_gtf_canonical_order_equal_jax(files):
    """sort_transcripts, move_canonical_to_zero (strictly longer) and
    move_all_canonical_to_zero order transcripts as the JAX's do."""
    for fn in ("sort_transcripts", "move_canonical_to_zero"):
        j, p = _genes(jgtf, files["gtf"]), _genes(gtf, files["gtf"])
        for jg, pg in zip(j.values(), p.values()):
            getattr(jgtf, fn)(jg)
            getattr(gtf, fn)(pg)
            assert ([t.transcript_id for t in pg.transcripts]
                    == [t.transcript_id for t in jg.transcripts])
    j, p = _genes(jgtf, files["gtf"]), _genes(gtf, files["gtf"])
    jgtf.move_all_canonical_to_zero(j)
    gtf.move_all_canonical_to_zero(p)
    assert [_gene_tuple(g) for g in p.values()] == [
        _gene_tuple(g) for g in j.values()]


@pytest.mark.parametrize("mask", ["exon_bool_array", "cds_bool_array",
                                  "five_utr_bool_array",
                                  "three_utr_bool_array"])
def test_gtf_masks_equal_jax(files, mask):
    j = getattr(jgtf, mask)(_genes(jgtf, files["gtf"]),
                            jchrom_info.read_to_map(files["sizes"]))
    p = getattr(gtf, mask)(_genes(gtf, files["gtf"]),
                           chrom_info.read_to_map(files["sizes"]))
    assert list(p) == list(j)
    for k in j:
        assert p[k].dtype == j[k].dtype == np.bool_
        assert np.array_equal(p[k], j[k])
    assert any(v.any() for v in p.values())


@pytest.mark.parametrize("up_down", [(0, 0), (700, 150), (30_000, 2)])
def test_gtf_beds_equal_jax(files, up_down):
    """The bed conversions as text against the JAX's; the canonical bed
    reorders the caller's genes alike."""
    up, down = up_down
    out = {}
    for side, mod, ci in (("jax", jgtf, jchrom_info), ("port", gtf,
                                                       chrom_info)):
        g = _genes(mod, files["gtf"])
        sizes = ci.read_to_map(files["sizes"])
        names = [x.gene_name for x in g.values()][::2] + ["N003", "N003"]
        out[side] = (
            [_beds(mod.gene_to_promoter_bed(x, sizes, up, down))
             for x in g.values()],
            _beds(mod.genes_to_tss_bed(g, sizes, False)),
            _beds(mod.genes_to_tss_bed(g, sizes, True)),
            [mod.gene_to_canonical_bed(x, sizes, up, down).to_string()
             for x in g.values()],
            [_gene_tuple(x) for x in g.values()],
            _beds(mod.genes_to_canonical_transcripts_tss_bed(g, sizes)),
            _beds(mod.genes_to_first_two_codon_bases(g)),
            _beds(mod.find_promoter(names, up, down, g, sizes)))
    assert out["port"] == out["jax"]
    assert all(out["port"][k] for k in (1, 2, 5, 6, 7))


def test_sam_interval_properties_equal_jax(files):
    """The port's Sam answers chrom, chrom_start and chrom_end as the
    JAX's, unmapped records and N, D and I CIGARs too."""
    _, j = jsam.read(files["sam"])
    _, p = sam.read(files["sam"])
    assert len(p) == len(j) > 100
    got = [(r.chrom, r.chrom_start, r.chrom_end) for r in p]
    assert got == [(r.chrom, r.chrom_start, r.chrom_end) for r in j]
    assert got == [(r.rname, sam.get_chrom_start(r), sam.get_chrom_end(r))
                   for r in p]
    assert ("*", -1, -1) in got
