"""The port's ``vcfFormat``, ``vcfToFa``, ``vcfFilter``, ``vcfInfo``,
``multiFaToVcf`` and ``bedFormat`` (gonomics_tpu_torch/cli/) on the CPU
against the JAX tools: the bytes of every output file, and the message
of every exit, on inputs that a numpy seed builds here (VCFs whose
header has ##INFO and ##FORMAT keys of every type and of Number 1, A, R,
G, . and 0, with '.' values, multi-allelic and indel records, phased,
unphased and missing genotypes and AA= annotations; multiFa alignments
with leading and trailing gap runs, N columns and three records; bed
records on both strands with p values, ties among them). Also the
library under them: ``io/vcf.py``'s ``parse_header_meta``,
``parse_info`` and ``parse_format`` against the JAX's, quirks included.
"""

import os

import numpy as np
import pytest

from gonomics_tpu.cli import bed_format as jbed_format
from gonomics_tpu.cli import multi_fa_to_vcf as jmulti_fa_to_vcf
from gonomics_tpu.cli import vcf_filter as jvcf_filter
from gonomics_tpu.cli import vcf_format as jvcf_format
from gonomics_tpu.cli import vcf_info as jvcf_info
from gonomics_tpu.cli import vcf_to_fa as jvcf_to_fa
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import vcf as jvcf
from gonomics_tpu_torch.cli import bed_format, multi_fa_to_vcf, vcf_filter
from gonomics_tpu_torch.cli import vcf_format, vcf_info, vcf_to_fa
from gonomics_tpu_torch.io import bed, fai
from gonomics_tpu_torch.io import vcf

TOOLS = {"vcfFormat": (jvcf_format.main, vcf_format.main),
         "vcfToFa": (jvcf_to_fa.main, vcf_to_fa.main),
         "vcfFilter": (jvcf_filter.main, vcf_filter.main),
         "vcfInfo": (jvcf_info.main, vcf_info.main),
         "multiFaToVcf": (jmulti_fa_to_vcf.main, multi_fa_to_vcf.main),
         "bedFormat": (jbed_format.main, bed_format.main)}

BASES = "ACGT"


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


def _lines(text: str) -> str:
    return "".join(ln + "\n" for ln in text.splitlines())


def _fa_text(records, width=60) -> str:
    return "".join(f">{name}\n" + "".join(
        seq[i:i + width] + "\n" for i in range(0, len(seq), width))
        for name, seq in records)


def _other(rng, base: str, k: int = 1) -> list[str]:
    return [str(b) for b in rng.choice([b for b in BASES if b != base], k,
                                       replace=False)]


RICH_HEADER = """##fileformat=VCFv4.2
##FILTER=<ID=q10,Description="Quality below 10">
##contig=<ID=chr1,length=300>
##INFO=<ID=DP,Number=1,Type=Integer,Description="Total depth, as DP=sum">
##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">
##INFO=<ID=AC,Number=R,Type=Integer,Description="Allele counts">
##INFO=<ID=GL,Number=G,Type=Float,Description="Likelihood">
##INFO=<ID=NL,Number=.,Type=Integer,Description="A list, maybe empty">
##INFO=<ID=NOTE,Number=.,Type=String,Description="Free text, commas kept">
##INFO=<ID=DB,Number=0,Type=Flag,Description="In dbSNP">
##INFO=<ID=CH,Number=1,Type=Character,Description="A letter">
##INFO=<ID=MQ,Number=1,Type=Float,Description="Mapping quality">
##INFO=<ID=AA,Number=1,Type=String,Description="Ancestral allele">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">
##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">
##FORMAT=<ID=HQ,Number=2,Type=Float,Description="Haplotype qualities">
##FORMAT=<ID=FT,Number=.,Type=String,Description="Sample filter">
##FORMAT=<ID=CC,Number=1,Type=Character,Description="A letter">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\ts1\ts2"""

GT_HEADER = """##fileformat=VCFv4.2
##INFO=<ID=AA,Number=1,Type=String,Description="Ancestral allele">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ta\tb\tc"""


def _rich_record(rng, chrom: str, pos: int, g: str, n: int) -> str:
    """One record of every kind in turn (SNP, two alts, insertion,
    deletion) with a random subset of the INFO keys and three samples."""
    ref = g[pos - 1]
    kind = int(rng.integers(0, 5))
    if kind in (0, 1):
        alt = _other(rng, ref)
    elif kind == 2:
        alt = _other(rng, ref, 2)
    elif kind == 3:
        alt = [ref + "".join(rng.choice(list(BASES),
                                        int(rng.integers(1, 4))))]
    else:
        ref = g[pos - 1:pos + int(rng.integers(1, 4))]
        alt = [ref[0]]
    na = len(alt)
    info = []
    pick = rng.random(10)
    if pick[0] < 0.8:
        info.append("DP=" + ("." if pick[0] < 0.1
                             else str(int(rng.integers(0, 30)))))
    if pick[1] < 0.7:
        info.append("AF=" + ("." if pick[1] < 0.1 else ",".join(
            str(float(x)) for x in rng.choice([0.125, 0.25, 0.5, 0.75],
                                              na))))
    if pick[2] < 0.5:
        info.append("AC=" + ",".join(str(int(x)) for x in
                                     rng.integers(0, 9, na + 1)))
    if pick[3] < 0.4:
        info.append("GL=" + str(rng.choice([".", "-1.5", "0"])))
    if pick[4] < 0.4:
        info.append("NL=" + str(rng.choice(["0", ".", "1,2", "3"])))
    if pick[5] < 0.3:
        info.append("NOTE=" + str(rng.choice(["a,b", "x", "p,q,r"])))
    if pick[6] < 0.4:
        info.append("DB")
    if pick[7] < 0.4:
        info.append("CH=" + str(rng.choice(["x", "yz", "w,v"])))
    if pick[8] < 0.5:
        info.append("MQ=" + str(rng.choice(["20", "45.5", "60"])))
    if pick[9] < 0.7:
        info.append("AA=" + str(rng.choice([ref, alt[0], "N", "-", "AC"])))
    info_s = ";".join(info) if info and rng.random() > 0.1 else "."
    gts = ["0|1", "1/1", "0/0", "./.", "1|0", "0/1", "1"]
    gts += ["1/2", "2|0"] if na > 1 else []
    short = rng.random() < 0.25
    fmt = "GT:GQ" if short else "GT:GQ:AD:HQ:FT:CC"
    samples = []
    for _ in range(3):
        gt = str(rng.choice(gts))
        gq = "." if rng.random() < 0.2 else str(int(rng.integers(0, 60)))
        if short:
            samples.append(f"{gt}:{gq}")
            continue
        ad = "." if rng.random() < 0.2 else ",".join(
            str(int(x)) for x in rng.integers(0, 20, na + 1))
        hq = "." if rng.random() < 0.2 else ",".join(
            str(float(x)) for x in rng.choice([3.5, 10.5, 21.0, 40.25], 2))
        ft = str(rng.choice(["PASS", "q10,s50"]))
        cc = str(rng.choice(["a", "bc"]))
        samples.append(f"{gt}:{gq}:{ad}:{hq}:{ft}:{cc}")
    rid = f"rs{n}" if rng.random() < 0.6 else "."
    qual = str(rng.choice(["30", "12.5", ".", "99", "7"]))
    filt = str(rng.choice(["PASS", "q10"]))
    return "\t".join([chrom, str(pos), rid, ref, ",".join(alt), qual, filt,
                      info_s, fmt, *samples])


def _gt_record(rng, chrom, pos, g, aa=None, gts=None) -> str:
    ref = g[pos - 1]
    alt = _other(rng, ref)[0]
    if gts is None:
        gts = ["0|1", "1/1", "0/0"]
        rng.shuffle(gts)
    aa = ref if aa is None else aa
    return "\t".join([chrom, str(pos), ".", ref, alt, "50", "PASS",
                      f"AA={aa if aa != 'alt' else alt}", "GT", *gts])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vcf_tools")
    rng = np.random.default_rng(2400)
    f = {}
    genome = {c: "".join(rng.choice(list(BASES), n))
              for c, n in (("chr1", 300), ("chr2", 200))}
    f["genome"] = genome
    f["ref"] = _write(tmp / "ref.fa", _fa_text(genome.items()))
    fai.write_index(fai.create_index(f["ref"]), f["ref"] + ".fai")
    # a copy with a lower-case run and an N, which vcfInfo's context skips
    soft = dict(genome)
    soft["chr1"] = (soft["chr1"][:100] + soft["chr1"][100:130].lower()
                    + "N" + soft["chr1"][131:])
    f["soft"] = _write(tmp / "soft.fa", _fa_text(soft.items()))
    fai.write_index(fai.create_index(f["soft"]), f["soft"] + ".fai")

    # rich.vcf: sorted, with records at one site and records closer than
    # a few bases (for -biAllelicOnly and -minDistance)
    lines, n = [RICH_HEADER], 0
    for chrom, g in genome.items():
        pos = 1
        while True:
            pos += int(rng.choice([0, 1, 2, 3, 5, 8, 13, 21]))
            if pos > len(g) - 5:
                break
            n += 1
            lines.append(_rich_record(rng, chrom, pos, g, n))
    f["n_rich"] = n
    f["alt2"] = next(r.split("\t")[4] for r in lines[1:]
                     if "," in r.split("\t")[4])
    f["rich"] = _write(tmp / "rich.vcf", _lines("\n".join(lines)))
    body = lines[1:]
    f["unsorted"] = _write(tmp / "unsorted.vcf", _lines("\n".join(
        [RICH_HEADER] + body[:5] + body[5:12][::-1] + body[12:])))
    # a sample of '.': its FORMAT values read as "", which int() refuses
    f["dot_sample"] = _write(tmp / "dot_sample.vcf", _lines(
        RICH_HEADER + "\nchr1\t5\t.\tA\tC\t30\tPASS\tDP=3\tGT:GQ\t.\t0/1:20"
        "\t1/1:30"))
    f["unknown_tag"] = _write(tmp / "unknown_tag.vcf", _lines(
        RICH_HEADER + "\nchr1\t5\t.\tA\tC\t30\tPASS\tZZ=3\tGT:GQ\t0/1:9"
        "\t0/1:20\t1/1:30"))
    f["groups"] = _write(tmp / "groups.txt", ">keep\ns0\ns2\n>other\nx\n")

    # daf.vcf: polarizable, segregating SNPs, the ancestor the ref or
    # the alt; and one file for each of the DAF exits
    daf = [GT_HEADER]
    for i, pos in enumerate(range(10, 290, 9)):
        gts = [str(rng.choice(["0|1", "1/1", "0/0", "1|0", "./."]))
               for _ in range(3)]
        if all(x in ("0/0", "./.") for x in gts):
            gts[0] = "0|1"
        if all(x in ("1/1", "./.") for x in gts):
            gts[1] = "0/0"
        daf.append(_gt_record(rng, "chr1", pos, genome["chr1"],
                              aa=None if i % 3 else "alt", gts=gts))
    f["daf"] = _write(tmp / "daf.vcf", _lines("\n".join(daf)))
    g1 = genome["chr1"]
    f["daf_unpolar"] = _write(tmp / "daf_unpolar.vcf", _lines("\n".join(
        daf[:4] + [_gt_record(rng, "chr1", 295, g1, aa="N")])))
    f["daf_fixed"] = _write(tmp / "daf_fixed.vcf", _lines("\n".join(
        daf[:4] + [_gt_record(rng, "chr1", 295, g1,
                              gts=["1/1", "1|1", "1/1"])])))
    f["daf_empty"] = _write(tmp / "daf_empty.vcf", _lines("\n".join(
        daf[:4] + [_gt_record(rng, "chr1", 295, g1,
                              gts=["./.", "./.", "./."])])))

    # snv.vcf: biallelic SNPs that match the genome, for vcfToFa and
    # vcfInfo; its variants on chr1 also at the alignment's columns
    snv = [GT_HEADER]
    for chrom, g in genome.items():
        for pos in sorted(rng.choice(np.arange(1, len(g) + 1), 25,
                                     replace=False).tolist()):
            gts = [str(rng.choice(["0|1", "1/1", "0/0", "./.", "1|0",
                                   "1/0", "."])) for _ in range(3)]
            snv.append(_gt_record(rng, chrom, pos, g,
                                  aa="alt" if rng.random() < 0.5 else None,
                                  gts=gts))
    f["snv"] = _write(tmp / "snv.vcf", _lines("\n".join(snv)))
    f["snv_chr1"] = [ln for ln in snv[1:] if ln.startswith("chr1\t")]
    mism = snv[:8] + [snv[8].replace(
        f"\t{snv[8].split(chr(9))[3]}\t",
        f"\t{_other(rng, snv[8].split(chr(9))[3])[0]}\t", 1)] + snv[9:]
    f["mismatch"] = _write(tmp / "mismatch.vcf", _lines("\n".join(mism)))
    # multiFa mode holds each record to the first one only
    f["snv_unsorted"] = _write(tmp / "snv_unsorted.vcf", _lines("\n".join(
        snv[:1] + [snv[2], snv[1]] + snv[3:])))
    multi = snv[:6] + [snv[6].replace(f"\t{snv[6].split(chr(9))[4]}\t",
                                      "\tA,C\t", 1)] + snv[7:]
    f["snv_multi"] = _write(tmp / "snv_multi.vcf", _lines("\n".join(multi)))
    # chr1 with gap columns, and a second row, as a multiFa alignment
    cols, row2 = [], []
    for b in genome["chr1"]:
        while rng.random() < 0.08:
            cols.append("-")
            row2.append(str(rng.choice(list(BASES))))
        cols.append(b)
        row2.append("-" if rng.random() < 0.05 else b)
    f["aln1"] = _write(tmp / "aln1.fa", _fa_text(
        [("chr1", "".join(cols)), ("other", "".join(row2))]))
    f["empty_fa"] = _write(tmp / "empty.fa", "")

    # info.vcf: every record with an ancestor; SNPs at position 1, at a
    # chromosome's last base and where a flank of 2 runs off its start,
    # on an unknown chromosome, in the soft-masked run, a ref that is
    # not the genome's, N and gap alleles, an indel
    inf = [GT_HEADER]
    c1, c2 = genome["chr1"], genome["chr2"]
    special = [("chr1", 1), ("chr1", 2), ("chr1", 115), ("chr1", 131),
               ("chr2", 200), ("chr2", 199)]
    for chrom, pos in special:
        inf.append(_gt_record(rng, chrom, pos, genome[chrom], aa="alt"))
    for chrom, g in genome.items():
        for pos in range(3, len(g) - 2, 4):
            inf.append(_gt_record(rng, chrom, pos, g,
                                  aa="alt" if rng.random() < 0.5 else None))
    inf += ["chrUn\t10\t.\tA\tG\t50\tPASS\tAA=A\tGT\t0|1\t0/0\t1/1",
            f"chr1\t20\t.\t{_other(rng, c1[19])[0]}\tG\t50\tPASS\tAA=G\t"
            "GT\t0|1\t0/0\t1/1",
            "chr1\t30\t.\tN\tA\t50\tPASS\tAA=A\tGT\t0|1\t0/0\t1/1",
            f"chr1\t31\t.\t{c1[30]}\tN\t50\tPASS\tAA=N\tGT\t0|1\t0/0\t1/1",
            "chr1\t40\t.\t-\tG\t50\tPASS\tAA=-\tGT\t0|1\t0/0\t1/1",
            f"chr1\t41\t.\t{c1[40]}\t-\t50\tPASS\tAA=-\tGT\t0|1\t0/0\t1/1",
            f"chr2\t50\t.\t{c2[49:52]}\t{c2[49]}\t50\tPASS\tAA={c2[49]}\t"
            "GT\t0|1\t0/0\t1/1"]
    f["info"] = _write(tmp / "info.vcf", _lines("\n".join(inf)))
    f["info_no_aa"] = _write(tmp / "info_no_aa.vcf", _lines("\n".join(
        inf[:5] + [inf[5].replace("AA=", "XA=")] + inf[6:])))

    # fix.vcf: "-" alleles for vcfFormat -fix, one with no ALT at all
    fx = ["##fileformat=VCFv4.2",
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    fx += [f"chr1\t1\t.\t{c1[0]}\t-\t30\tPASS\t.",
           f"chr1\t12\t.\t{c1[11]}\t-\t30\tPASS\t.",
           f"chr1\t25\t.\t{c1[24]}\t-,T\t30\tPASS\t.",
           f"chr1\t40\t.\t{c1[39]}\tT,-\t30\tPASS\t.",
           "chr1\t50\t.\t-\t\t30\tPASS\t.",
           "chr1\t60\t.\t-\tA\t30\tPASS\t.",
           f"chr2\t7\t.\t{c2[6]}\tA\t30\tPASS\t.",
           f"chr2\t90\t.\t{c2[89]}\t-\t30\tPASS\t."]
    f["fix"] = _write(tmp / "fix.vcf", _lines("\n".join(fx)))
    ens = [GT_HEADER] + [
        ln.replace("chr1\t", f"{c}\t", 1) for c, ln in zip(
            ["1", "2", "X", "Y", "MT", "22", "chrUn", "23"], snv[1:9])]
    f["ens"] = _write(tmp / "ens.vcf", _lines("\n".join(ens)))
    f["headerless"] = _write(tmp / "headerless.vcf", _lines("\n".join(
        snv[1:5])))
    return f


# --- vcfFilter ------------------------------------------------------------

FILTERS = {
    "none": [],
    "chrom": ["-chrom", "chr2"],
    "pos": ["-minPos", "50", "-maxPos", "200"],
    "qual": ["-minQual", "20"],
    "ref_alt": ["-ref", "A", "-alt", "C"],
    "alt_two": ["-alt", "ALT2"],
    "biallelic": ["-biAllelicOnly"],
    "substitutions": ["-substitutionsOnly"],
    "segregating": ["-segregatingSitesOnly"],
    "no_ancestor": ["-removeNoAncestor"],
    "polarizable": ["-onlyPolarizableAncestors"],
    "ws_or_sw": ["-weakToStrongOrStrongToWeakOnly"],
    "no_ws_sw": ["-noWeakToStrongOrStrongToWeak"],
    "ref_weak": ["-refWeakAltStrongOnly"],
    "ref_strong": ["-refStrongAltWeakOnly"],
    "not_ref_strong": ["-notRefStrongAltWeak"],
    "not_ref_weak": ["-notRefWeakAltStrong"],
    "id": ["-id", "."],
    "info_gt": ["-info", "DP>10"],
    "info_ge": ["-info", "DP>=10"],
    "info_lt": ["-info", "DP<10"],
    "info_le": ["-info", "DP<=10"],
    "info_eq": ["-info", "DP=12"],
    "info_ne": ["-info", '"DP!=12"'],
    "info_float": ["-info", "AF>=0.25"],
    "info_two": ["-info", "DP>5;MQ<50"],
    "info_flag": ["-info", "DB"],
    "info_string": ["-info", "AA=A"],
    "info_list_r": ["-info", "AC<5"],
    "info_char": ["-info", "CH=x"],
    "info_missing": ["-info", "MQ>30", "-includeMissingInfo"],
    "format_gt": ["-format", "GQ>20"],
    "format_le": ["-format", "GQ<=20"],
    "format_float": ["-format", "HQ>=10.5"],
    "format_string": ["-format", "FT=PASS", "-includeMissingInfo"],
    "format_info": ["-format", "GQ!=0", "-info", "DP>3"],
    "subset": ["-subSet", "0.5", "-setSeed", "7"],
    "subset_after_tests": ["-chrom", "chr1", "-substitutionsOnly",
                           "-subSet", "0.4", "-setSeed", "3"],
    "min_distance": ["-minDistance", "5"],
    "min_distance_biallelic_subset": ["-minDistance", "4",
                                      "-biAllelicOnly", "-subSet", "0.6",
                                      "-setSeed", "11"],
    "group": ["-groupFile", "GROUPS"],
    "group_info": ["-groupFile", "GROUPS", "-format", "GQ>10"],
}


@pytest.mark.parametrize("case", list(FILTERS))
def test_vcf_filter(files, tmp_path, case):
    """Each test on the rich VCF: the JAX tool's records, header and
    -subSet draws, byte for byte."""
    args = [{"GROUPS": files["groups"], "ALT2": files["alt2"]}.get(a, a)
            for a in FILTERS[case]]
    got = _both(tmp_path, "vcfFilter",
                lambda d: [files["rich"], d + "/out.vcf", *args])
    text = got["out.vcf"].decode()
    kept = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert len(kept) <= files["n_rich"]
    if case in ("none", "group"):
        assert len(kept) == files["n_rich"]
    elif case in ("alt_two", "id"):
        assert kept
    elif case.startswith("group"):
        assert "\ts0\ts2\n" in text and "\ts1" not in text
        assert all(len(ln.split("\t")) == 11 for ln in kept)


@pytest.mark.parametrize("case", [["-minDaf", "0.2"], ["-maxDaf", "0.8"],
                                  ["-minDaf", "0.1", "-maxDaf", "0.9",
                                   "-onlyPolarizableAncestors"]])
def test_vcf_filter_daf(files, tmp_path, case):
    """Derived allele frequencies, the ancestor the ref or the alt."""
    got = _both(tmp_path, "vcfFilter",
                lambda d: [files["daf"], d + "/out.vcf", *case])
    kept = [ln for ln in got["out.vcf"].decode().splitlines()
            if not ln.startswith("#")]
    assert 0 < len(kept) <= 32


@pytest.mark.parametrize("src,args,want", [
    ("daf_unpolar", ["-minDaf", "0.1"],
     "DAF filters require polarizable input variants."),
    ("daf_fixed", ["-maxDaf", "0.9"],
     "variant is nonsegregating (frequency 0 or 1)"),
    ("daf_empty", ["-minDaf", "0.1"], "variant had no sample data"),
    ("rich", ["-info", "XX>3"], "tag 'XX' not described in header"),
    ("rich", ["-format", "DP>3"], "tag 'DP' not described in header"),
    ("rich", ["-info", "DB=1"], "flag 'DB' cannot take a value"),
    ("unsorted", ["-minDistance", "3"], "input vcf is not sorted"),
    ("dot_sample", ["-format", "GQ>3"], "ValueError"),
    ("unknown_tag", ["-info", "DP>3"], "ValueError"),
])
def test_vcf_filter_exits(files, tmp_path, src, args, want):
    got = _both(tmp_path, "vcfFilter",
                lambda d: [files[src], d + "/out.vcf", *args])
    assert isinstance(got, str) and got.startswith(want)


# --- vcfToFa --------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["-useAlt"],
    ["-multiFaMode", "-multiFaChromName", "chr1", "-useAlt"],
    ["-multiFaMode", "-multiFaChromName", "chr1", "-useSamples"],
    ["-multiFaMode", "-multiFaChromName", "chr1", "-useSamples",
     "-haploid"],
    ["-multiFaMode", "-multiFaChromName", "chr1", "-useAlt", "-useSamples"],
])
def test_vcf_to_fa(files, tmp_path, args):
    """In place on the genome, and as edited copies of the alignment's
    first record at its columns, diploid and haploid."""
    multi = "-multiFaMode" in args
    src = files["aln1"] if multi else files["ref"]
    got = _both(tmp_path, "vcfToFa",
                lambda d: [files["snv"], src, d + "/out.fa", *args])
    names = [ln[1:] for ln in got["out.fa"].decode().splitlines()
             if ln.startswith(">")]
    if not multi:
        assert names == ["chr1", "chr2"]
    else:
        n = 2 + ("-useAlt" in args) + ("-useSamples" in args) * (
            3 if "-haploid" in args else 6)
        assert len(names) == n


def test_vcf_to_fa_applies_the_alts(files, tmp_path):
    """The plain mode's chr1 is the genome with each alt in place."""
    got = _both(tmp_path, "vcfToFa",
                lambda d: [files["snv"], files["ref"], d + "/out.fa",
                           "-useAlt"])
    want = list(files["genome"]["chr1"])
    for ln in files["snv_chr1"]:
        r = ln.split("\t")
        want[int(r[1]) - 1] = r[4]
    text = got["out.fa"].decode().split(">")[1]
    assert "".join(text.splitlines()[1:]) == "".join(want)


@pytest.mark.parametrize("src,fa,args,want", [
    ("mismatch", "ref", ["-useAlt"], "Error: base in fasta didn't match"),
    ("mismatch", "aln1", ["-multiFaMode", "-multiFaChromName", "chr1",
                          "-useAlt"], "Error: base in fasta didn't match"),
    ("snv_unsorted", "aln1", ["-multiFaMode", "-multiFaChromName", "chr1",
                              "-useAlt"], "Input VCF variants must be"),
    ("snv_multi", "ref", ["-useAlt"], "Error: currently we only handle"),
    ("snv", "ref", [], "Error: you must use at least one option"),
    ("snv", "aln1", ["-multiFaMode", "-useAlt"], "Must specify a chrom"),
    ("snv", "empty_fa", ["-multiFaMode", "-multiFaChromName", "chr1",
                         "-useSamples"], "Input fasta must contain"),
])
def test_vcf_to_fa_exits(files, tmp_path, src, fa, args, want):
    got = _both(tmp_path, "vcfToFa",
                lambda d: [files[src], files[fa], d + "/out.fa", *args])
    assert isinstance(got, str) and got.startswith(want)


# --- vcfInfo --------------------------------------------------------------

@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("pad", [0, 1, 2])
def test_vcf_info(files, tmp_path, pad, comp):
    """-types, -divergence and -context together, over a SNP at position
    1, flanks off either end of a chromosome, an unknown chromosome and a
    soft-masked run."""
    args = ["-pad", str(pad)] + (["-includeComplements"] if comp else [])
    got = _both(tmp_path, "vcfInfo",
                lambda d: ["-i", files["info"], "-types", d + "/types.txt",
                           "-divergence", d + "/div.txt", "-context",
                           d + "/ctx.txt", "-r", files["soft"], *args])
    assert b"Gap To G:\t" in got["types.txt"]
    ctx = got["ctx.txt"].decode().splitlines()
    assert len(ctx) == 1 + (12 if comp else 6) * 4 ** (2 * pad)
    assert sum(int(ln.split("\t")[2]) for ln in ctx[1:]) > 0


@pytest.mark.parametrize("src,args,want", [
    ("info_no_aa", ["-divergence", "DIR/d.txt"],
     "Divergence can only be evaluated"),
    ("info", [], "ERROR: must use at least one of"),
])
def test_vcf_info_exits(files, tmp_path, src, args, want):
    got = _both(tmp_path, "vcfInfo", lambda d: ["-i", files[src], *[
        a.replace("DIR", d) for a in args]])
    assert isinstance(got, str) and got.startswith(want)


# --- vcfFormat ------------------------------------------------------------

@pytest.mark.parametrize("src,args", [
    ("rich", ["-clearInfo"]),
    ("rich", ["-UCSCToEnsembl"]),
    ("ens", ["-ensemblToUCSC"]),
    ("rich", ["-csv"]),
    ("rich", ["-csv", "-clearInfo"]),
    ("snv", ["-csv"]),
    ("fix", ["-fix", "-ref", "REF"]),
    ("fix", ["-fix", "-ref", "REF", "-UCSCToEnsembl", "-csv"]),
])
def test_vcf_format(files, tmp_path, src, args):
    args = [files["ref"] if a == "REF" else a for a in args]
    got = _both(tmp_path, "vcfFormat",
                lambda d: [files[src], d + "/out.txt", *args])
    lines = got["out.txt"].decode().splitlines()
    if "-csv" in args:  # a header line, then a line a record
        with open(files[src]) as fh:
            n = sum(not ln.startswith("#") for ln in fh)
        assert len(lines) == 1 + n and lines[0].startswith("Chromosome,")
    if src == "ens":
        assert [ln.split("\t")[0] for ln in lines[4:]] == [
            "chr1", "chr2", "chrX", "chrY", "MT", "chr22", "chrUn", "23"]


@pytest.mark.parametrize("src,args,want", [
    ("rich", ["-ensemblToUCSC", "-UCSCToEnsembl"],
     "Both conversions are incompatible."),
    ("headerless", ["-csv"], "no vcf header found"),
    ("dot_sample", ["-csv"], "ValueError"),
    ("unknown_tag", ["-csv"], "ValueError: Info tag 'ZZ' not in header"),
])
def test_vcf_format_exits(files, tmp_path, src, args, want):
    got = _both(tmp_path, "vcfFormat",
                lambda d: [files[src], d + "/out.txt", *args])
    assert isinstance(got, str) and got.startswith(want)


# --- multiFaToVcf ---------------------------------------------------------

def _aln_rows(rng, n: int, lead: str, n_rows: int = 2) -> list[str]:
    """n_rows aligned rows: substitutions, N runs, gap runs in every row,
    substitutions beside gaps; lead "ref" opens the first row with gaps
    and ends a query with them, lead "query" the other way round."""
    ref = list(rng.choice(list(BASES), n))
    rows = [ref]
    for _ in range(n_rows - 1):
        q = [str(rng.choice(list(BASES))) if rng.random() < 0.08 else b
             for b in ref]
        for _ in range(6):
            a, k = int(rng.integers(5, n - 10)), int(rng.integers(1, 5))
            q[a:a + k] = ["-"] * k
            q[a - 1] = _other(rng, ref[a - 1])[0]  # beside the gap
        for _ in range(3):
            a = int(rng.integers(5, n - 5))
            q[a:a + 2] = ["N", "N"]
        rows.append(q)
    for _ in range(5):
        a, k = int(rng.integers(5, n - 10)), int(rng.integers(1, 4))
        ref[a:a + k] = ["-"] * k
    ref[int(rng.integers(5, n - 5))] = "N"
    if lead == "ref":
        ref[:3] = ["-"] * 3
        rows[1][-2:] = ["-"] * 2
    else:
        rows[1][:2] = ["-"] * 2
        ref[-3:] = ["-"] * 3
    return ["".join(r) for r in rows]


@pytest.fixture(scope="module")
def alns(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_fa")
    rng = np.random.default_rng(2401)
    out = {}
    for lead in ("ref", "query"):
        rows = _aln_rows(rng, 240, lead)
        out[lead] = _write(tmp / f"{lead}.fa", _fa_text(
            zip(("hg38", "panTro6"), rows)))
    rows = _aln_rows(rng, 240, "ref", 3)
    out["three"] = _write(tmp / "three.fa", _fa_text(
        zip(("hg38", "q1", "q2"), rows)))
    rows = _aln_rows(rng, 60, "query", 4)
    out["four"] = _write(tmp / "four.fa", _fa_text(
        zip(("a", "b", "c", "d"), rows)))
    out["one"] = _write(tmp / "one.fa", _fa_text([("a", rows[0])]))
    return out


@pytest.mark.parametrize("retain", [False, True])
@pytest.mark.parametrize("subs", [False, True])
@pytest.mark.parametrize("lead", ["ref", "query"])
def test_multi_fa_to_vcf_pairwise(alns, tmp_path, lead, subs, retain):
    """The pairwise state machine with and without -substitutionsOnly
    and -retainN, gaps leading either row."""
    args = (["-substitutionsOnly"] if subs else []) + (
        ["-retainN"] if retain else [])
    got = _both(tmp_path, "multiFaToVcf",
                lambda d: [alns[lead], "chr7", d + "/out.vcf", *args])
    recs = [ln.split("\t") for ln in got["out.vcf"].decode().splitlines()
            if not ln.startswith("#")]
    assert len(recs) > 10
    if subs:
        assert all(len(r[3]) == len(r[4]) == 1 for r in recs)
    else:
        assert any(len(r[3]) != len(r[4]) for r in recs)
    if retain:
        assert any("N" in (r[3], r[4]) for r in recs)


@pytest.mark.parametrize("args", [[], ["-secondQueryName", "q2"],
                                  ["-secondQueryName", "q1",
                                   "-substitutionsOnly"]])
def test_multi_fa_to_vcf_three(alns, tmp_path, args):
    """Three records: genotypes a column, or the first record against the
    named one."""
    got = _both(tmp_path, "multiFaToVcf",
                lambda d: [alns["three"], "chr7", d + "/out.vcf", *args])
    recs = [ln.split("\t") for ln in got["out.vcf"].decode().splitlines()
            if not ln.startswith("#")]
    assert recs
    if not args:
        assert {r[9] for r in recs} <= {"1/0", "0/1", "1/1", "1/2"}


@pytest.mark.parametrize("src,args,want", [
    ("four", [], "Error: expecting 2 or 3 sequences"),
    ("one", [], "Error: expecting 2 or 3 sequences"),
    ("three", ["-secondQueryName", "nope"],
     "Error: second query name is specified"),
])
def test_multi_fa_to_vcf_exits(alns, tmp_path, src, args, want):
    got = _both(tmp_path, "multiFaToVcf",
                lambda d: [alns[src], "chr7", d + "/out.vcf", *args])
    assert isinstance(got, str) and got.startswith(want)


def test_vcf_format_csv_of_multi_fa_to_vcf_raises(alns, tmp_path):
    """multiFaToVcf writes a FORMAT of ".", which no header names, so
    vcfFormat -csv of its VCF raises the JAX's ValueError."""
    src = str(tmp_path / "m.vcf")
    multi_fa_to_vcf.main([alns["ref"], "chr7", src, "-substitutionsOnly"])
    got = _both(tmp_path, "vcfFormat",
                lambda d: [src, d + "/out.csv", "-csv"])
    assert got == "ValueError: Format tag '.' not in header"


# --- bedFormat ------------------------------------------------------------

@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bed_format")
    rng = np.random.default_rng(2402)
    sizes = {"chr1": 300, "chr2": 200, "1": 300, "X": 150}
    out = {"sizes": _write(tmp / "t.sizes", "".join(
        f"{c}\t{n}\n" for c, n in sizes.items()))}
    rows = []
    # p values with ties; the smallest -0.0, for max(0.0, -0.0)
    pvals = ["3.5", "2", "2", "7.25", "0.5", "2", "-0.0", "12", "0.5"]
    for i in range(36):
        c = list(sizes)[i % 4]
        s = int(rng.integers(0, sizes[c] - 20))
        e = s + int(rng.integers(1, 20))
        name = str(rng.choice(["1.5", "0.1", "3", "1e-3", "2.75"]))
        rows.append([c, s, e, name, int(rng.integers(0, 1000)), "+-"[i % 2],
                     str(rng.choice(pvals)), str(rng.choice(pvals))])
    rows[0][1:3] = [0, 4]  # clipped at 0 by padding
    rows[1][1:3] = [sizes[rows[1][0]] - 3, sizes[rows[1][0]]]
    out["bed8"] = _write(tmp / "b8.bed", "".join(
        "\t".join(map(str, r)) + "\n" for r in rows))
    out["bed3"] = _write(tmp / "b3.bed", "".join(
        f"{r[0]}\t{r[1]}\t{r[2]}\n" for r in rows))
    out["dot"] = _write(tmp / "dot.bed", "".join(
        f"{r[0]}\t{r[1]}\t{r[2]}\tn\t0\t.\n" for r in rows[:4]))
    out["missing"] = _write(tmp / "missing.bed", "chr1\t5\t9\tn\t0\t+\n"
                            "chrZ\t5\t9\tn\t0\t-\n")
    return out


@pytest.mark.parametrize("src,args", [
    ("bed3", ["-coordName"]),
    ("bed8", ["-coordName"]),
    ("bed8", ["-ToMidpoint"]),
    ("bed8", ["-ToTss"]),
    ("bed8", ["-evenPadLength", "15", "-chromSizeFile", "SIZES"]),
    ("bed8", ["-upstreamPadLength", "7", "-chromSizeFile", "SIZES"]),
    ("bed8", ["-downstreamPadLength", "9", "-chromSizeFile", "SIZES"]),
    ("bed8", ["-ensemblToUCSC"]),
    ("bed8", ["-UCSCToEnsembl"]),
    ("bed8", ["-scaleNameFloat", "2.5"]),
    ("bed8", ["-scaleNameFloat", "0.3333333333"]),
    ("bed8", ["-fdrAnnotation"]),
    ("bed8", ["-fdrAnnotation", "-rawPValueAnnotationField", "1"]),
    ("bed8", ["-coordName", "-ToMidpoint", "-evenPadLength", "20",
              "-chromSizeFile", "SIZES", "-UCSCToEnsembl"]),
    ("bed3", ["-ToMidpoint", "-evenPadLength", "4", "-chromSizeFile",
              "SIZES", "-ensemblToUCSC"]),
])
def test_bed_format(beds, tmp_path, src, args):
    args = [beds["sizes"] if a == "SIZES" else a for a in args]
    got = _both(tmp_path, "bedFormat",
                lambda d: [beds[src], d + "/out.bed", *args])
    lines = got["out.bed"].decode().splitlines()
    assert len(lines) == 36
    if "-fdrAnnotation" in args:
        assert all(len(ln.split("\t")) == 9 for ln in lines)
        assert any(ln.endswith("\t0.000000e+00") for ln in lines)


@pytest.mark.parametrize("src,args,want", [
    ("bed8", ["-ensemblToUCSC", "-UCSCToEnsembl"],
     "Both conversions (UCSCToEnsembl and EnsemblToUCSC)"),
    ("bed8", ["-evenPadLength", "3"], "Must specify a chromFile"),
    ("bed8", ["-ToTss", "-ToMidpoint"], "Cannot trim bed elements"),
    ("missing", ["-evenPadLength", "3", "-chromSizeFile", "SIZES"],
     "Chrom for current bed entry not found in chromSizes file. "
     "BedChrom: chrZ."),
    ("missing", ["-upstreamPadLength", "3", "-chromSizeFile", "SIZES"],
     "Chrom for current bed entry not found"),
    ("missing", ["-downstreamPadLength", "3", "-chromSizeFile", "SIZES"],
     "Chrom for current bed entry not found"),
    ("dot", ["-upstreamPadLength", "3", "-chromSizeFile", "SIZES"],
     "Bed entries must have annotated strand information to perform "
     "upstream padding."),
    ("dot", ["-downstreamPadLength", "3", "-chromSizeFile", "SIZES"],
     "Bed entries must have annotated strand information to perform "
     "downstream padding."),
    ("dot", ["-ToTss"], "ValueError: bed must have +/- strand for Tss"),
    ("bed8", ["-fdrAnnotation", "-rawPValueAnnotationField", "2"],
     "Error: rawPValueAnnotationField, 2, exceeds"),
])
def test_bed_format_exits(beds, tmp_path, src, args, want):
    args = [beds["sizes"] if a == "SIZES" else a for a in args]
    got = _both(tmp_path, "bedFormat",
                lambda d: [beds[src], d + "/out.bed", *args])
    assert isinstance(got, str) and got.startswith(want)


@pytest.mark.parametrize("strand", ["+", "-", "."])
def test_bed_trims(strand):
    """to_midpoint and to_tss give the JAX's record, or its ValueError."""
    for s, e in ((10, 11), (10, 20), (10, 21)):
        line = f"chr1\t{s}\t{e}\tn\t5\t{strand}\tx"
        ours, theirs = bed.process_bed_line(line), jbed.process_bed_line(line)
        assert vars(bed.to_midpoint(ours)) == vars(jbed.to_midpoint(theirs))
        got = want = None
        try:
            want = vars(jbed.to_tss(theirs))
        except ValueError as err:
            want = str(err)
        try:
            got = vars(bed.to_tss(ours))
        except ValueError as err:
            got = str(err)
        assert got == want
        assert vars(ours) == vars(theirs)  # the copies left it as it was


# --- the library ----------------------------------------------------------

def _parsed(mod, path):
    """[(parse_info, parse_format)] of each record, each an exception's
    type and message where it raises, read and parsed by mod."""
    records, header = mod.read(path)
    meta = mod.parse_header_meta(header)
    out = []
    for v in records:
        row = []
        for fn in (mod.parse_info, mod.parse_format):
            try:
                row.append(fn(v, meta))
            except ValueError as e:
                row.append(f"ValueError: {e}")
        out.append(row)
    return out


@pytest.mark.parametrize("src", ["rich", "dot_sample", "unknown_tag",
                                 "daf", "snv", "fix"])
def test_parse_header_meta_info_format(files, src):
    """The keys in file order with their Number and Type, the samples,
    and every record's typed INFO and FORMAT: the JAX's."""
    _, jh = jvcf.read(files[src])
    _, h = vcf.read(files[src])
    jm, m = jvcf.parse_header_meta(jh), vcf.parse_header_meta(h)
    for field in ("info", "format"):
        assert [(k, vars(x)) for k, x in getattr(m, field).items()] == [
            (k, vars(x)) for k, x in getattr(jm, field).items()]
    assert m.samples == jm.samples
    assert _parsed(vcf, files[src]) == _parsed(jvcf, files[src])
    if src == "rich":
        assert list(m.info) == ["DP", "AF", "AC", "GL", "NL", "NOTE", "DB",
                                "CH", "MQ", "AA"]
        assert m.info["DP"].is_format is False
        assert m.format["HQ"].number == "2" and m.format["HQ"].is_format


@pytest.mark.parametrize("info,want", [
    ("DP=.", {"DP": [[0]]}),
    ("AF=.", {"AF": [[0.0, 0.0]]}),
    ("AF=0", {"AF": [[0.0, 0.0]]}),
    ("AF=0.5,0", {"AF": [[0.5, 0.0]]}),
    ("AC=0", {"AC": [[0, 0, 0]]}),
    ("GL=.", {"GL": [[0.0]]}),
    ("NL=0", {"NL": [[]]}),
    ("NL=.", {"NL": [[]]}),
    ("NL=0,0", {"NL": [[0, 0]]}),
    ("NOTE=a,b", {"NOTE": [["a,b"]]}),
    ("CH=yz,w", {"CH": [["y"]]}),
    ("CH=", {"CH": [[]]}),
    ("DB;DP=4", {"DB": True, "DP": [[4]]}),
    (".", {}),
    ("ZZ=1", "ValueError: Info tag 'ZZ' not in header"),
    ("DP=x", "ValueError"),
])
def test_parse_info_quirks(files, info, want):
    """'.' reads as zero, a list that is one zero expands to get_number
    zeros (none for Number '.'), String keeps its commas, Character is
    the first letter, an unknown tag raises; as in the JAX."""
    line = f"chr1\t5\t.\tA\tC,G\t30\tPASS\t{info}\tGT:GQ\t0/1:.\t1|2:0"
    got = []
    for mod in (vcf, jvcf):
        _, header = mod.read(files["rich"])
        meta = mod.parse_header_meta(header)
        try:
            got.append(mod.parse_info(mod.process_vcf_line(line), meta))
        except ValueError as e:
            got.append(f"ValueError: {e}")
    assert got[0] == got[1]
    if isinstance(want, dict):
        assert got[0] == want
    else:
        assert got[0].startswith(want)


def test_parse_format_skips_gt(files):
    line = ("chr1\t5\t.\tA\tC\t30\tPASS\t.\tGT:GQ:AD:HQ:FT:CC\t"
            "0/1:.:.:.:PASS:ab\t1|1:7:0:3.5,.:q1,s2:c")
    _, header = vcf.read(files["rich"])
    got = vcf.parse_format(vcf.process_vcf_line(line),
                           vcf.parse_header_meta(header))
    _, jheader = jvcf.read(files["rich"])
    want = jvcf.parse_format(jvcf.process_vcf_line(line),
                             jvcf.parse_header_meta(jheader))
    assert got == want == {"GQ": [[0], [7]], "AD": [[0, 0], [0, 0]],
                           "HQ": [[0.0, 0.0], [3.5, 0.0]],
                           "FT": [["PASS"], ["q1,s2"]], "CC": [["a"], ["c"]]}
    assert [vcf.get_number(vcf.process_vcf_line(line), k)
            for k in vcf.parse_header_meta(header).info.values()] == [
        1, 1, 2, 1, 0, 0, 0, 1, 1, 1]
