"""The port's interval and lift tools (``bedpeFilter``, ``bedpeOverlap``,
``intervalContacts``, ``intervalSubsetMatrix``, ``geneAssignmentStats``,
``overlapEnrichments``, ``liftCoordinates``, ``divergenceSpectrum``;
gonomics_tpu_torch/cli/) on the CPU against the JAX tools: the bytes of
every file they write, their stdout, and the message of every exit, on
inputs that a numpy seed builds here: beds of 3, 6 and 8 fields on chr1,
chr2 and chr10 (whose string order differs from their number order),
bedpe files of 6, 10 and 12 fields, chains with plus- and minus-strand
queries (and one with a minus target strand), SNP and indel VCFs, and a
small query FASTA with its .fai. Each quirk of the reference that the
port keeps is pinned by a case here. Also the library under them:
``bedpe.process_line`` and ``to_string``, ``t_pos_to_q_pos``,
``merge_beds_keep_names_and_annotations`` and every public function of
``lift_enrichment`` against the JAX's, floats by their 64 bits.
"""

import contextlib
import io
import os
import struct

import numpy as np
import pytest

from gonomics_tpu import lift_enrichment as jlift
from gonomics_tpu.cli import bedpe_filter as jbedpe_filter
from gonomics_tpu.cli import bedpe_overlap as jbedpe_overlap
from gonomics_tpu.cli import divergence_spectrum as jdivergence
from gonomics_tpu.cli import gene_assignment_stats as jgene_stats
from gonomics_tpu.cli import interval_contacts as jcontacts
from gonomics_tpu.cli import interval_subset_matrix as jsubset
from gonomics_tpu.cli import lift_coordinates as jlift_coords
from gonomics_tpu.cli import overlap_enrichments as jenrich
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import bedpe as jbedpe
from gonomics_tpu.io import formats as jformats
from gonomics_tpu_torch import dna
from gonomics_tpu_torch import lift_enrichment as lift
from gonomics_tpu_torch.cli import bedpe_filter, bedpe_overlap
from gonomics_tpu_torch.cli import divergence_spectrum as divergence
from gonomics_tpu_torch.cli import gene_assignment_stats as gene_stats
from gonomics_tpu_torch.cli import interval_contacts as contacts
from gonomics_tpu_torch.cli import interval_subset_matrix as subset
from gonomics_tpu_torch.cli import lift_coordinates as lift_coords
from gonomics_tpu_torch.cli import overlap_enrichments as enrich
from gonomics_tpu_torch.io import bed, bedpe, fai, formats

TOOLS = {"bedpeFilter": (jbedpe_filter.main, bedpe_filter.main),
         "bedpeOverlap": (jbedpe_overlap.main, bedpe_overlap.main),
         "intervalContacts": (jcontacts.main, contacts.main),
         "intervalSubsetMatrix": (jsubset.main, subset.main),
         "geneAssignmentStats": (jgene_stats.main, gene_stats.main),
         "overlapEnrichments": (jenrich.main, enrich.main),
         "liftCoordinates": (jlift_coords.main, lift_coords.main),
         "divergenceSpectrum": (jdivergence.main, divergence.main)}

SIZES = [("chr1", 3000), ("chr2", 1500), ("chr10", 800)]
NAMES = ["gA", "gB", "gC", "gD", "gE", "gF"]


def _both(tmp_path, tool: str, argv) -> dict:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own, and holds their exits, stdout and the files they
    wrote under d equal; returns the port's {"exit": message or None,
    "stdout": text, "files": {name: bytes}}. An exit is the SystemExit's
    message, or the type and message of any other exception."""
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
        except Exception as e:  # the JAX tools' ValueError, KeyError, ...
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


def _foot(rng, chrom=None, max_len=200):
    if chrom is None:
        chrom, size = SIZES[int(rng.integers(0, len(SIZES)))]
    else:
        size = dict(SIZES)[chrom]
    start = int(rng.integers(0, size - max_len))
    return chrom, start, start + int(rng.integers(1, max_len))


def _bedpe_rows(rng, n: int) -> list[list[str]]:
    """n contacts of 12 fields, about half within one chromosome."""
    out = []
    for _ in range(n):
        a = _foot(rng)
        b = _foot(rng, a[0] if rng.random() < 0.5 else None)
        out.append([a[0], str(a[1]), str(a[2]), b[0], str(b[1]), str(b[2]),
                    str(rng.choice(NAMES)), str(int(rng.integers(0, 100))),
                    str(rng.choice(list("+-."))),
                    str(rng.choice(list("+-."))), f"{rng.random():.3f}",
                    str(rng.choice(["x", "y"]))])
    return out


def _bed_rows(rng, n: int, max_len=200) -> list[list[str]]:
    """n beds of 8 fields, named from NAMES."""
    out = []
    for _ in range(n):
        c, s, e = _foot(rng, max_len=max_len)
        out.append([c, str(s), str(e), str(rng.choice(NAMES)),
                    str(int(rng.integers(0, 1000))),
                    str(rng.choice(["+", "-"])), f"{rng.random():.4f}", "z"])
    return out


def _tiles(rng, every: int, lo: int, hi: int, keep: float = 0.6):
    """Non-overlapping spans of 10-99 bp, one start a grid cell of every
    bp, kept with probability keep, over SIZES."""
    out = []
    for c, size in SIZES:
        for s in range(0, size - every, every):
            if rng.random() < keep:
                length = int(rng.integers(lo, hi))
                out.append(f"{c}\t{s}\t{s + length}")
    return out


VCF_HEAD = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2"]


def _vcf_line(chrom, pos, ref, alt, info=".", gts=("0/1", "1|1")) -> str:
    return (f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t30\tPASS\t{info}\tGT\t"
            + "\t".join(gts))


# --- the chains of liftCoordinates: chr1 to q1 (plus, a deletion, an
# insertion and a double gap), chr2 to q2 (minus query strand, a double
# gap), chr10 [0, 400) to q3 and [500, 800) to q4 (plus)
CHR1_BLOCKS = [(1000, 5, 0), (800, 0, 3), (700, 4, 2), (491, 0, 0)]
CHR2_BLOCKS = [(600, 10, 10), (880, 0, 0)]


def _chain_text(score, t, t_size, t_strand, t0, t1, q, q_size, q_strand,
                q0, q1, cid, blocks) -> str:
    body = "\n".join(f"{s}\t{tb}\t{qb}" for s, tb, qb in blocks[:-1])
    return (f"chain {score} {t} {t_size} {t_strand} {t0} {t1} {q} {q_size} "
            f"{q_strand} {q0} {q1} {cid}\n" + body
            + ("\n" if body else "") + f"{blocks[-1][0]}\n\n")


def _through(target: np.ndarray, blocks, rng) -> np.ndarray:
    """The query of target through blocks: target bases in blocks, a
    target gap dropped, a query gap filled with random bases."""
    parts, t = [], 0
    for size, tb, qb in blocks:
        parts.append(target[t:t + size])
        t += size + tb
        parts.append(rng.integers(0, 4, qb).astype(np.int8))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("interval_tools")
    rng = np.random.default_rng(2900)
    f = {}
    rows = _bedpe_rows(rng, 80)
    for k in (6, 10, 12):
        f[f"pe{k}"] = _write(tmp / f"pe{k}.bedpe",
                             ["\t".join(r[:k]) for r in rows])
    beds = _bed_rows(rng, 40)
    for k in (3, 6, 8):
        f[f"b{k}"] = _write(tmp / f"b{k}.bed",
                            ["\t".join(r[:k]) for r in beds])
    f["b3_unnamed"] = f["b3"]
    # bedpe select files: copies of some contacts, their feet shifted
    sel = []
    for r in rows[::3]:
        s = list(r)
        for i in (1, 4):
            shift = int(rng.integers(-30, 30))
            s[i] = str(max(0, int(s[i]) + shift))
            s[i + 1] = str(max(int(s[i]) + 1, int(s[i + 1]) + shift))
        sel.append(s[:6])
    sel += [r[:6] for r in _bedpe_rows(rng, 15)]
    f["sel_pe"] = _write(tmp / "sel.bedpe", ["\t".join(s) for s in sel])
    # the last A-side hit: the select's A foot hits both A feet, its B
    # foot only the first contact's B foot
    f["home_in"] = _write(tmp / "home_in.bedpe", [
        "chr1\t100\t200\tchr2\t100\t200\tfirst\t1",
        "chr1\t150\t250\tchr2\t900\t1000\tsecond\t2"])
    f["home_sel"] = _write(tmp / "home_sel.bedpe",
                           ["chr1\t160\t170\tchr2\t120\t130"])
    # -bedSelect edge: A foot misses, B foot overlaps two select beds
    f["bside_in"] = _write(tmp / "bside_in.bedpe", [
        "chr2\t10\t20\tchr1\t100\t200\tc\t5",
        "chr1\t100\t200\tchr2\t10\t20\td\t6"])
    f["bside_sel"] = _write(tmp / "bside_sel.bed", [
        "chr1\t90\t180\ts1\t0\t+", "chr1\t110\t210\ts2\t0\t+",
        "chr1\t195\t400\ts3\t0\t+"])
    f["odd_strands"] = _write(tmp / "odd.bedpe", [
        "chr1\t1\t50\tchr2\t3\t90\tn\t4\t+-\t\tq\tr",
        "chr1\t10\t60\tchr1\t30\t70\tm\t7\tx\t-",
        "chr2\t5\t9\tchr10\t1\t2\tk\t2\t.\t+\ta"])
    # intervalSubsetMatrix: union windows (a duplicate, string order),
    # the file list of beds and a VCF
    union = [f"{c}\t{s}\t{s + 250}" for c, n in SIZES
             for s in range(0, n - 250, 250)]
    union.append(union[3])
    f["union"] = _write(tmp / "union.bed", union)
    snps = []
    for c, n in SIZES:
        for p in sorted(rng.choice(np.arange(1, n), 25, replace=False)):
            ref, alt = rng.choice(list("ACGT"), 2, replace=False)
            snps.append(_vcf_line(c, int(p), ref, alt))
    f["snps"] = _write(tmp / "snps.vcf", VCF_HEAD + snps)
    f["list"] = _write(tmp / "list.txt", [f["b3"], f["b6"], f["snps"]])
    f["list_txt"] = _write(tmp / "list_txt.txt", [f["b3"], str(tmp / "x.txt")])
    # geneAssignmentStats: each truth A foot overlapped by a test record,
    # its name the truth's half the time
    truth, test = [], []
    for i in range(40):
        a = _foot(rng, max_len=120)
        b = _foot(rng)
        name = str(rng.choice(NAMES))
        truth.append([a[0], str(a[1]), str(a[2]), b[0], str(b[1]), str(b[2]),
                      name, "0", "+", "-", f"{i}", "w"])
        mid = (a[1] + a[2]) // 2
        test.append(f"{a[0]}\t{mid}\t{mid + 5}\t"
                    + (name if rng.random() < 0.5 else "other"))
    f["truth10"] = _write(tmp / "truth10.bedpe",
                          ["\t".join(t[:10]) for t in truth])
    f["truth12"] = _write(tmp / "truth12.bedpe",
                          ["\t".join(t) for t in truth])
    f["test"] = _write(tmp / "test.bed", test + [
        "\t".join(r[:4]) for r in _bed_rows(rng, 20)])
    f["test_short"] = _write(tmp / "test_short.bed", test[:10])
    # one merged region "n1,n2"; test records visited before the match
    f["pin_truth"] = _write(tmp / "pin_truth.bedpe", [
        "chr1\t100\t200\tchr2\t5\t10\tn1\t0\t+\t+",
        "chr1\t150\t300\tchr2\t900\t950\tn2\t0\t+\t+",
        "chr2\t100\t200\tchr1\t10\t20\tn3\t0\t+\t+"])
    f["pin_test"] = _write(tmp / "pin_test.bed", [
        "chr1\t100\t110\tzz", "chr1\t120\t130\tyy", "chr1\t140\t150\tn2",
        "chr2\t100\t110\tqq"])
    # overlapEnrichments: a gapped search space, elements1 tiles inside
    # it, elements2 spans (some overlapping each other) and SNPs
    space = []
    for c, n in SIZES:
        space += [f"{c}\t0\t{n // 2 - 40}", f"{c}\t{n // 2 + 40}\t{n}"]
    f["space"] = _write(tmp / "space.bed", space)
    f["space_whole"] = _write(tmp / "space_whole.bed",
                              [f"{c}\t0\t{n}" for c, n in SIZES])

    def inside(line):
        c, s, e = line.split("\t")
        n = dict(SIZES)[c]
        return int(e) <= n // 2 - 40 or int(s) >= n // 2 + 40

    f["e1"] = _write(tmp / "e1.bed", [x for x in _tiles(rng, 100, 10, 90)
                                      if inside(x)])
    f["e1_gap"] = _write(tmp / "e1_gap.bed", _tiles(rng, 100, 10, 90))
    e2 = [x for x in _tiles(rng, 90, 1, 60, keep=0.4) if inside(x)]
    f["e2"] = _write(tmp / "e2.bed", e2)
    f["e2_gap"] = _write(tmp / "e2_gap.bed", e2 + ["chr1\t1480\t1500"])
    f["e2_vcf"] = _write(tmp / "e2.vcf", VCF_HEAD + [
        s for s in snps if inside("\t".join([s.split("\t")[0],
                                             str(int(s.split("\t")[1]) - 1),
                                             s.split("\t")[1]]))])
    f["e2_list"] = _write(tmp / "e2_list.txt", [f["e2"], f["e2_vcf"]])
    f["space_self"] = _write(tmp / "space_self.bed",
                             space + ["chr1\t10\t20"])
    f["e1_self"] = _write(tmp / "e1_self.bed",
                          ["chr1\t10\t50", "chr1\t40\t60"])
    f["far"] = _write(tmp / "far.bed", ["chr1\t1470\t1490"])
    # liftCoordinates: the target, the query through the chains (SNPs
    # planted in q1), the query FASTA and its .fai
    target = {c: rng.integers(0, 4, n).astype(np.int8) for c, n in SIZES}
    q1 = _through(target["chr1"], CHR1_BLOCKS, rng)
    planted = [p for p in range(20, 990, 37)]
    for p in planted:
        q1[p] = (q1[p] + 1) % 4
    q2 = dna.reverse_complement(_through(target["chr2"], CHR2_BLOCKS,
                                         rng)).astype(np.int8)
    queries = {"q1": q1, "q2": q2, "q3": target["chr10"][:400],
               "q4": target["chr10"][500:]}
    fa = tmp / "q.fa"
    with open(fa, "w") as fh:
        for name, seq in queries.items():
            s = dna.to_string(seq)
            fh.write(f">{name}\n")
            fh.writelines(s[i:i + 50] + "\n" for i in range(0, len(s), 50))
    f["qfa"] = str(fa)
    fai.write_index(fai.create_index(str(fa)), str(fa) + ".fai")
    chain = (_chain_text(100, "chr1", 3000, "+", 0, 3000, "q1", len(q1), "+",
                         0, len(q1), 1, CHR1_BLOCKS)
             + _chain_text(90, "chr2", 1500, "+", 0, 1500, "q2", len(q2), "-",
                           0, len(q2), 2, CHR2_BLOCKS)
             + _chain_text(80, "chr10", 800, "+", 0, 400, "q3", 400, "+", 0,
                           400, 3, [(400, 0, 0)])
             + _chain_text(70, "chr10", 800, "+", 500, 800, "q4", 300, "+",
                           0, 300, 4, [(300, 0, 0)]))
    f["chain"] = _write(tmp / "t_q.chain", [chain])
    f["chain_minus_t"] = _write(tmp / "minus_t.chain", [_chain_text(
        60, "chr1", 3000, "-", 0, 3000, "q1", len(q1), "+", 0, len(q1), 5,
        CHR1_BLOCKS)])
    lift_beds = []
    for _ in range(60):
        c, s, e = _foot(rng, str(rng.choice(["chr1", "chr2"])), 60)
        lift_beds.append([c, str(s), str(e), "r", "3", "+"])
    lift_beds += [["chr10", "10", "50", "a", "1", "-"],
                  ["chr10", "600", "700", "b", "2", "+"],
                  ["chr10", "390", "510", "two", "0", "+"],
                  ["chrU", "5", "10", "none", "0", "+"],
                  ["chr1", "990", "1010", "gap", "0", "+"]]
    for k in (3, 6):
        f[f"lift{k}"] = _write(tmp / f"lift{k}.bed",
                               ["\t".join(r[:k]) for r in lift_beds])
    f["lift_edge"] = _write(tmp / "lift_edge.bed", ["chr10\t380\t450"])
    f["lift_end"] = _write(tmp / "lift_end.bed", ["chr10\t100\t401"])
    # the lift VCF: SNPs whose alt q1 carries (planted), whose ref it
    # carries, whose bases it lacks; indels, a multiallelic site, a SNP in
    # the deleted bases, on the minus chain, off every chain
    t1 = dna.to_string(target["chr1"])
    vl = []
    for i, p in enumerate(planted):
        ref, alt = t1[p], dna.to_string(q1[p:p + 1])
        info = f"ALLELE_A={ref}x;ALLELE_B={alt}y" if i % 2 else "."
        vl.append((p + 1, _vcf_line("chr1", p + 1, ref, alt, info)))
    for p in (1100, 1200, 1300):
        ref = t1[p]
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        vl.append((p + 1, _vcf_line("chr1", p + 1, ref, alt,
                                    "ALLELE_A=x;ALLELE_B=y")))
    for p in (1400, 1500):
        ref = t1[p]
        others = [b for b in "ACGT" if b != ref]
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        third = next(b for b in others if b != alt)
        vl.append((p + 1, _vcf_line("chr1", p + 1, alt, third)))
    vl.append((2001, _vcf_line("chr1", 2001, t1[2000:2003], t1[2000])))
    vl.append((2101, _vcf_line("chr1", 2101, t1[2100], t1[2100] + "GT")))
    vl.append((2201, _vcf_line("chr1", 2201, t1[2200], "A,C")))
    vl.append((1003, _vcf_line("chr1", 1003, t1[1002], "A")))
    vl.sort()
    t2 = dna.to_string(target["chr2"])
    vl += [(0, _vcf_line("chr2", p + 1, t2[p], "ACGT"[(
        "ACGT".index(t2[p]) + 2) % 4])) for p in (50, 300, 1200)]
    vl += [(0, _vcf_line("chrU", 7, "A", "G"))]
    f["lift_vcf"] = _write(tmp / "lift.vcf", VCF_HEAD + [v for _, v in vl])
    # divergenceSpectrum: windows over SIZES; the SNP VCF, an indel
    # inside a window, an indel outside every window
    f["windows"] = _write(tmp / "windows.bed",
                          [f"{c}\t{s}\t{s + 300}\tw{s}" for c, n in SIZES
                           for s in range(0, n - 300, 300)])
    f["windows3"] = _write(tmp / "windows3.bed",
                           [f"{c}\t{s}\t{s + 400}" for c, n in SIZES
                            for s in range(0, n - 400, 400)])
    f["indel_in"] = _write(tmp / "indel_in.vcf", VCF_HEAD + snps[:5]
                           + [_vcf_line("chr1", 2000, "AC", "A")])
    f["indel_out"] = _write(tmp / "indel_out.vcf", VCF_HEAD + snps[:5] + [
        _vcf_line("chr1", 2990, "AC", "A")])
    f["lower"] = _write(tmp / "lower.vcf", VCF_HEAD + [
        _vcf_line("chr2", 40, "a", "c")])
    return f


# --- bedpeFilter --------------------------------------------------------

BEDPE_FILTER_CASES = {
    "defaults": ["{pe10}"],
    "defaults_6": ["{pe6}"],
    "defaults_12": ["{pe12}"],
    "distance": ["{pe10}", "-minDistance", "300", "-maxDistance", "1500"],
    "score": ["{pe12}", "-minScore", "20", "-maxScore", "70"],
    "score_6": ["{pe6}", "-minScore", "1"],
    # the start test drops a record only when both feet start outside
    "start": ["{pe10}", "-minStart", "400", "-maxStart", "900"],
    "chrom": ["{pe10}", "-chrom", "chr10"],
    "intra": ["{pe12}", "-onlyIntraChrom"],
    "inter": ["{pe12}", "-onlyInterChrom", "-minDistance", "100"],
    "both_chrom_flags": ["{pe10}", "-onlyIntraChrom", "-onlyInterChrom"],
    "start_order": ["{pe10}", "-minStart", "500", "-maxStart", "500"],
    "odd_strands": ["{odd_strands}"],
}


@pytest.mark.parametrize("case", sorted(BEDPE_FILTER_CASES))
def test_bedpe_filter(files, tmp_path, case):
    args = [a.format(**files) for a in BEDPE_FILTER_CASES[case]]
    got = _both(tmp_path, "bedpeFilter",
                lambda d: [args[0], d + "/out.bedpe"] + args[1:])
    if case in ("both_chrom_flags", "start_order"):
        assert got["exit"] in ("Cannot set both onlyIntraChrom and "
                               "onlyInterChrom",
                               "Max Start must be greater than Min Start")
        return
    assert got["exit"] is None
    out = _lines(got, "out.bedpe")
    if case == "start":
        keep = [r for r in out if 400 <= int(r.split("\t")[1]) <= 900
                or 400 <= int(r.split("\t")[4]) <= 900]
        assert out == keep and any(
            not 400 <= int(r.split("\t")[1]) <= 900 for r in out)
    if case == "odd_strands":
        assert out[0].split("\t")[8:10] == ["+-", ""]
        assert out[1].split("\t")[8] == "."


# --- bedpeOverlap -------------------------------------------------------

BEDPE_OVERLAP_CASES = {
    "bedpe_select": ["{sel_pe}", "{pe10}"],
    "bedpe_select_12": ["{sel_pe}", "{pe12}"],
    "last_home": ["{home_sel}", "{home_in}"],
    "bed": ["-bedSelect", "{b6}", "{pe10}"],
    "bed_half": ["-bedSelect", "-overlapThreshold", "0.5", "{b6}", "{pe10}"],
    "bed_names": ["-bedSelect", "-keepNames", "{b6}", "{pe6}"],
    "bed_names_half": ["-bedSelect", "-keepNames", "-overlapThreshold",
                       "0.3", "{b8}", "{pe12}"],
    "bed_names_unnamed": ["-bedSelect", "-keepNames", "{b3}", "{pe10}"],
    "both": ["-bedSelect", "-overlapBoth", "{b6}", "{pe10}"],
    "both_half": ["-bedSelect", "-overlapBoth", "-overlapThreshold", "0.5",
                  "{b3}", "{pe12}"],
    "b_side_twice": ["-bedSelect", "-overlapThreshold", "0.4",
                     "{bside_sel}", "{bside_in}"],
    "b_side_names": ["-bedSelect", "-keepNames", "-overlapThreshold", "0.4",
                     "{bside_sel}", "{bside_in}"],
    "threshold_range": ["-bedSelect", "-overlapThreshold", "1.5", "{b6}",
                        "{pe10}"],
    "threshold_alone": ["-overlapThreshold", "0.5", "{sel_pe}", "{pe10}"],
    "both_alone": ["-overlapBoth", "{sel_pe}", "{pe10}"],
}


@pytest.mark.parametrize("case", sorted(BEDPE_OVERLAP_CASES))
def test_bedpe_overlap(files, tmp_path, case):
    args = [a.format(**files) for a in BEDPE_OVERLAP_CASES[case]]
    got = _both(tmp_path, "bedpeOverlap",
                lambda d: args + [d + "/out.bedpe"])
    if case in ("threshold_range", "threshold_alone", "both_alone",
                "bed_names_unnamed"):
        assert got["exit"]
        return
    assert got["exit"] is None
    out = _lines(got, "out.bedpe")
    if case == "last_home":
        # the first contact matched; the second's A foot came last
        assert out == ["chr1\t150\t250\tchr2\t900\t1000\tsecond\t2"]
    if case == "b_side_twice":
        # the A foot of "c" misses; its B foot passes against s1 and s2
        assert out.count("chr2\t10\t20\tchr1\t100\t200\tc\t5") == 2
        assert out.count("chr1\t100\t200\tchr2\t10\t20\td\t6") == 1
    if case == "b_side_names":
        assert out[0].split("\t")[6] == "s1,s2,s3"
    if case.startswith("bedpe_select") or case == "bed":
        assert out


# --- intervalContacts ---------------------------------------------------

@pytest.mark.parametrize("pe", ["pe6", "pe10", "pe12"])
@pytest.mark.parametrize("inp", ["b3", "b8", "snps"])
def test_interval_contacts(files, tmp_path, pe, inp):
    got = _both(tmp_path, "intervalContacts",
                lambda d: [files[pe], files[inp], d + "/out.bed"])
    assert got["exit"] is None
    out = _lines(got, "out.bed")
    assert out
    # a foot as a bed of the line's field count: 6 columns and the
    # annotations; a 6-field foot with an empty name, score 0, strand .
    assert {len(ln.split("\t")) for ln in out} == {8 if pe == "pe12" else 6}
    if pe == "pe6":
        assert all(ln.split("\t")[3:] == ["", "0", "."] for ln in out)


def test_interval_contacts_unknown_type(files, tmp_path):
    got = _both(tmp_path, "intervalContacts",
                lambda d: [files["pe10"], files["e2_list"], d + "/out.bed"])
    assert got["exit"].startswith("ValueError: unsupported interval file")


# --- intervalSubsetMatrix -----------------------------------------------

@pytest.mark.parametrize("mode", ["binary", "fraction", "binary_multi",
                                  "fraction_multi", "unknown_type"])
def test_interval_subset_matrix(files, tmp_path, mode):
    flags = []
    if mode.startswith("fraction"):
        flags.append("-fraction")
    lst = files["list_txt" if mode == "unknown_type" else "list"]
    got = _both(tmp_path, "intervalSubsetMatrix", lambda d: [
        files["union"], lst, d + "/m.tsv"] + flags + (
        ["-markMultipleOverlaps", d + "/multi.tsv"]
        if mode.endswith("multi") else []))
    if mode == "unknown_type":
        assert got["exit"].startswith("ValueError")
        return
    assert got["exit"] is None
    rows = _lines(got, "m.tsv")
    keys = [r.split("\t")[0] for r in rows[1:]]
    # string order, the duplicate union region one row
    assert keys == sorted(set(keys)) and len(keys) == len(
        open(files["union"]).read().splitlines()) - 1
    assert keys.index("chr1:1000-1250") < keys.index("chr1:250-500")
    if mode == "binary_multi":  # ov_size never leaves 0 here
        multi = _lines(got, "multi.tsv")
        assert all(set(r.split("\t")[1:]) == {"0"} for r in multi[1:])
    if mode == "fraction_multi":
        multi = _lines(got, "multi.tsv")
        assert any(set(r.split("\t")[1:]) - {"0"} for r in multi[1:])


# --- geneAssignmentStats ------------------------------------------------

@pytest.mark.parametrize("truth,test", [("truth10", "test"),
                                        ("truth12", "test"),
                                        ("truth10", "test_short"),
                                        ("pin_truth", "pin_test")])
def test_gene_assignment_stats(files, tmp_path, truth, test):
    got = _both(tmp_path, "geneAssignmentStats", lambda d: [
        files[truth], files[test], d + "/m.bed", d + "/n.bed"])
    if test == "test_short":
        assert got["exit"] == "No overlap found for guide"
        return
    assert got["exit"] is None
    freq = float(got["stdout"])
    assert got["stdout"] == repr(freq) + "\n"
    if truth == "pin_truth":
        # "n1,n2" is matched by n2, the tree's second hit: one non-match
        # row for yy, visited before it (none for zz, after it), with the
        # last name; its annotations are n1's distance twice (the merge
        # appends the first again), so n2's own 750 never shows; n3 by
        # none
        assert _lines(got, "m.bed") == ["chr1\t100\t300\tn2,n2\t0\t.\t95"]
        assert _lines(got, "n.bed") == [
            "chr1\t100\t300\tn2,yy\t0\t.\t95",
            "chr2\t100\t200\tn3,qq\t0\t.\t90"]
        assert freq == 0.5


# --- overlapEnrichments -------------------------------------------------

ENRICH_CASES = {
    "exact": ["exact", "{e1}", "{e2}", "{space}"],
    "exact_vcf": ["exact", "{e1}", "{e2_vcf}", "{space}"],
    "normal": ["normalApproximate", "{e1}", "{e2}", "{space}"],
    "upper": ["upperBound", "{e1}", "{e2}", "{space}"],
    "lower": ["lowerBound", "{e1}", "{e2}", "{space}"],
    "list": ["upperBound", "{e1}", "unused", "{space}", "-secondFileList",
             "{e2_list}"],
    "trim": ["exact", "{e1_gap}", "{e2_gap}", "{space}",
             "-trimToSearchSpace"],
    "trim_any": ["lowerBound", "{e1_gap}", "{e2_gap}", "{space}",
                 "-trimToSearchSpace", "-relationship", "any"],
    "whole_space": ["normalApproximate", "{e1_gap}", "{e2_gap}",
                    "{space_whole}"],
    "unknown_method": ["best", "{e1}", "{e2}", "{space}"],
    "e1_outside": ["exact", "{e1_gap}", "{e2}", "{space}"],
    "e2_outside": ["exact", "{e1}", "{e2_gap}", "{space}"],
    "space_self": ["exact", "{e1}", "{e2}", "{space_self}"],
    "e1_self": ["exact", "{e1_self}", "{e2}", "{space_whole}"],
    # elements1 trimmed away: an expected overlap of 0
    "zero_expected": ["upperBound", "{far}", "{e2}", "{space}",
                      "-trimToSearchSpace"],
    "zero_expected_exact": ["exact", "{far}", "{e2}", "{space}",
                            "-trimToSearchSpace"],
}


@pytest.mark.parametrize("case", sorted(ENRICH_CASES))
def test_overlap_enrichments(files, tmp_path, case):
    args = [a.format(**files) for a in ENRICH_CASES[case]]
    got = _both(tmp_path, "overlapEnrichments",
                lambda d: args[:4] + [d + "/out.tsv"] + args[4:])
    if case.startswith("zero_expected"):
        assert got["exit"].startswith("ZeroDivisionError")
        return
    if case in ("unknown_method", "e1_outside", "e2_outside", "space_self",
                "e1_self"):
        want = {"unknown_method": "Error: unknown method. Found: best.",
                "e1_outside": "Error: foreground element from file 1 does "
                "not overlap search space. Please use 'trimToSearchSpace' "
                "to exclude this element.",
                "e2_outside": "Error: foreground element from file 2 does "
                "not overlap search space.",
                "space_self": "Elements in bedEnrichments must not be "
                "self-overlapping. Self-overlap found in "
                f"{files['space_self']}.",
                "e1_self": "Elements in bedEnrichments must not be "
                f"self-overlapping. Self-overlap found in {files['e1_self']}."}
        assert got["exit"] == want[case]
        return
    assert got["exit"] is None
    rows = _lines(got, "out.tsv")
    assert len(rows) == (3 if case == "list" else 2)
    assert all(int(r.split("\t")[5]) > 0 for r in rows[1:])


# --- liftCoordinates ----------------------------------------------------

LIFT_CASES = {
    "bed3": ["{chain}", "{lift3}"],
    "bed6": ["{chain}", "{lift6}"],
    "bed_loose": ["{chain}", "{lift6}", "-minMatch", "0.5"],
    "bed_strict": ["{chain}", "{lift3}", "-minMatch", "1"],
    "vcf": ["{chain}", "{lift_vcf}"],
    "vcf_fa": ["{chain}", "{lift_vcf}", "-faFile", "{qfa}"],
    "vcf_fa_swap": ["{chain}", "{lift_vcf}", "-faFile", "{qfa}", "-swapAB"],
    "bed_fa": ["{chain}", "{lift6}", "-faFile", "{qfa}"],
    "min_match": ["{chain}", "{lift6}", "-minMatch", "1.2"],
    "past_chain": ["{chain}", "{lift_edge}"],
    "chain_end": ["{chain}", "{lift_end}"],
    "minus_target": ["{chain_minus_t}", "{lift3}"],
}


@pytest.mark.parametrize("case", sorted(LIFT_CASES))
def test_lift_coordinates(files, tmp_path, case):
    args = [a.format(**files) for a in LIFT_CASES[case]]
    ext = ".vcf" if args[1].endswith(".vcf") else ".bed"
    got = _both(tmp_path, "liftCoordinates", lambda d: args[:2] + [
        d + "/out" + ext, d + "/un.txt"] + args[2:])
    if case in ("bed_fa", "min_match", "past_chain", "minus_target"):
        assert got["exit"] == {
            "bed_fa": "Fasta file is provided but lift file is not VCF",
            "min_match": "minMatch must be between 0 and 1",
            "past_chain": "ValueError: TPos not within the range of the "
            "chain",
            "minus_target": "ValueError: all target strands should be "
            "positive"}[case]
        return
    assert got["exit"] is None
    out, un = _lines(got, "out" + ext), _lines(got, "un.txt")
    if case == "chain_end":  # end - 1 is t_end: past the last block
        assert out == ["q3\t100\t1"]
    if case.startswith("bed"):
        assert any(ln.startswith("Record below maps to multiple chains")
                   for ln in un)
        assert any(ln.startswith("Record below has no ortholog")
                   for ln in un)
        assert any(ln.startswith("Record below fails minMatch")
                   for ln in un) != (case == "bed_loose")
        assert any(ln.startswith("q2\t") for ln in out)
    if case.startswith("vcf_fa"):
        inverted = [i for i, ln in enumerate(un)
                    if ln.startswith("Record below was lifted, but")]
        assert inverted
        assert sum("INDEL records" in ln for ln in un) == 2
        assert sum("multiallelic" in ln for ln in un) == 1
        assert sum(ln.startswith("For the following record, neither")
                   for ln in un) >= 2
        # the probe of a multi-base REF starts at pos: 2001 lifts to 2000
        assert "q1\t2000\t.\t" + un[un.index(next(
            ln for ln in un if "INDEL records" in ln)) + 1].split(
            "\t", 3)[3] in un
        # -swapAB swaps the first characters of the two values alone
        inv = [ln.split("\t") for ln in out
               if "x;ALLELE_B=" in ln and "ALLELE_A=x" not in ln]
        assert inv
        for w in inv:
            a, b = w[7].split(";")
            assert a[len("ALLELE_A="):] == (w[3] if case == "vcf_fa_swap"
                                            else w[4]) + "x"
            assert b[len("ALLELE_B="):] == (w[4] if case == "vcf_fa_swap"
                                            else w[3]) + "y"
        assert any(ln.endswith("\t1/0\t0|0") for ln in out)


# --- divergenceSpectrum -------------------------------------------------

@pytest.mark.parametrize("bed_key,vcf_key", [
    ("windows", "snps"), ("windows3", "snps"), ("windows", "indel_in"),
    ("windows", "indel_out"), ("windows3", "lower")])
def test_divergence_spectrum(files, tmp_path, bed_key, vcf_key):
    got = _both(tmp_path, "divergenceSpectrum", lambda d: [
        files[bed_key], files[vcf_key], d + "/out.bed"])
    if vcf_key in ("indel_in", "lower"):
        assert got["exit"] == {"indel_in": "Poorly formed VCF. Ref: AC. "
                               "Alt: A.", "lower": "Poorly formed VCF. "
                               "Ref: a. Alt: c."}[vcf_key]
        return
    assert got["exit"] is None
    out = _lines(got, "out.bed")
    assert all(len(ln.split("\t")) == 12 for ln in out)
    if vcf_key == "snps":
        assert sum(int(x) for ln in out for x in ln.split("\t")[6:]) > 0


# --- the library ----------------------------------------------------------

def _bits(x) -> bytes:
    return b"".join(struct.pack("<d", v) for v in np.ravel(x).tolist())


def _bed_vars(recs) -> list[dict]:
    return [vars(r) for r in recs]


def test_bedpe_process_line_and_to_string(files):
    lines = []
    for k in ("pe6", "pe10", "pe12", "odd_strands", "home_in"):
        lines += open(files[k]).read().splitlines()
    for ln in lines:
        got, want = bedpe.process_line(ln), jbedpe.process_line(ln)
        assert (vars(got.a), vars(got.b)) == (vars(want.a), vars(want.b))
        assert got.to_string() == want.to_string()
        # a strand not within "+-." reads as "."
        assert got.to_string() == ln.replace("\tx\t", "\t.\t")
        for n in range(6, 13):
            assert got.to_string(n) == want.to_string(n)
    for mod in (bedpe, jbedpe):
        with pytest.raises(ValueError, match="at least 6 bedPe fields"):
            mod.process_line(lines[0]).to_string(5)
    got, want = bedpe.read(files["pe12"]), jbedpe.read(files["pe12"])
    bedpe.annotate_feet_dist(got)
    jbedpe.annotate_feet_dist(want)
    bedpe.contacts_to_midpoints(got)
    jbedpe.contacts_to_midpoints(want)
    assert [r.to_string() for r in got] == [r.to_string() for r in want]
    halves = [vars(h) | {"home": h.home.to_string()}
              for r in got for h in bedpe.split_bedpe(r)]
    jhalves = [vars(h) | {"home": h.home.to_string()}
               for r in want for h in jbedpe.split_bedpe(r)]
    assert halves == jhalves


def test_t_pos_to_q_pos(files):
    got, _ = formats.read_chain(files["chain"])
    want, _ = jformats.read_chain(files["chain"])
    for c, jc in zip(got, want):
        for t in range(c.t_start, c.t_end + 1):
            assert formats.t_pos_to_q_pos(c, t) == \
                jformats.t_pos_to_q_pos(jc, t)
        assert formats.t_pos_to_q_pos(c, c.t_end) == (0, False)
        for t in (c.t_start - 1, c.t_end + 1):
            for mod, ch in ((formats, c), (jformats, jc)):
                with pytest.raises(ValueError, match="TPos not within"):
                    mod.t_pos_to_q_pos(ch, t)
        for s in range(c.t_start, c.t_end, 7):
            e = min(c.t_end, s + 40)
            assert lift_coords.match_proportion(c, s, e) == \
                jlift_coords.match_proportion(jc, s, e)
            assert lift_coords.lift_with_chain(c, s, e) == \
                jlift_coords.lift_with_chain(jc, s, e)
    minus, _ = formats.read_chain(files["chain_minus_t"])
    jminus, _ = jformats.read_chain(files["chain_minus_t"])
    for mod, ch in ((formats, minus[0]), (jformats, jminus[0])):
        with pytest.raises(ValueError, match="target strands"):
            mod.t_pos_to_q_pos(ch, 5)


@pytest.mark.parametrize("key", ["b6", "b8", "truth12", "pin"])
def test_merge_beds_keep_names_and_annotations(files, key):
    if key == "pin":  # names joined, scores summed, the first annotation
        lines = ["chr1\t0\t10\ta\t1\t+\tx", "chr1\t5\t20\tb\t2\t-\ty",
                 "chr1\t19\t30\tc\t4\t+\tz", "chr10\t0\t5\td\t8\t+\tw"]
        got = bed.merge_beds_keep_names_and_annotations(
            [bed.process_bed_line(ln) for ln in lines])
        assert [r.to_string() for r in got] == [
            "chr1\t0\t30\ta,b,c\t7\t+\tx\tx\tx", lines[3]]
        return
    lines = open(files[key]).read().splitlines()
    if key == "b6":
        lines = [f"{ln}\ta{i}" for i, ln in enumerate(lines)]
    if key == "truth12":  # the truth's A feet, its last two fields kept
        lines = ["\t".join(w[:3] + [w[6], "1", "+"] + w[10:])
                 for w in (ln.split("\t") for ln in lines)]
    got = bed.merge_beds_keep_names_and_annotations(
        [bed.process_bed_line(ln) for ln in lines])
    want = jbed.merge_beds_keep_names_and_annotations(
        [jbed.process_bed_line(ln) for ln in lines])
    assert _bed_vars(got) == _bed_vars(want)
    assert len(got) < len(lines)
    assert any("," in r.name for r in got)


def _spans(mod, path):
    recs = mod.go_read(path)
    mod.sort_by_coord(recs)
    return recs


@pytest.mark.parametrize("e1,e2,space", [("e1", "e2", "space"),
                                         ("e1", "e2_vcf", "space"),
                                         ("e1_gap", "e2_gap", "space_whole"),
                                         ("b3", "b6", "space_whole")])
def test_lift_enrichment_library(files, e1, e2, space):
    p = {k: _spans(lift, files[k]) for k in (e1, e2, space)}
    j = {k: _spans(jlift, files[k]) for k in (e1, e2, space)}
    for k in p:
        assert _bed_vars(p[k]) == _bed_vars(j[k])
        assert lift.is_self_overlapping(p[k]) == \
            jlift.is_self_overlapping(j[k])
    assert lift.overlap_count(p[e2], p[e1]) == \
        jlift.overlap_count(j[e2], j[e1])
    assert lift.overlap_count(p[e1], p[e2]) == \
        jlift.overlap_count(j[e1], j[e2])
    for a, b in ((3, 0), (0, 5), (12, 7)):
        assert _bed_vars(lift._subtract_from_coord(p[e1], a, b)) == \
            _bed_vars(jlift._subtract_from_coord(j[e1], a, b))
    assert lift._overlap_length_sum(p[e1], p[space]) == \
        jlift._overlap_length_sum(j[e1], j[space])
    for length in (1, 5, 40):
        assert _bits(lift._overlap_probability(p[e1], length, p[space])) \
            == _bits(jlift._overlap_probability(j[e1], length, j[space]))
    probs = lift.element_overlap_probabilities(p[e1], p[e2], p[space])
    jprobs = jlift.element_overlap_probabilities(j[e1], j[e2], j[space])
    assert _bits(probs) == _bits(jprobs)
    overlap = lift.overlap_count(p[e2], p[e1])
    assert len(probs) <= 100
    for k in sorted({0, overlap, len(probs) // 2, len(probs)}):
        assert _bits(lift.enrichment_p_value_exact(probs, k)) == \
            _bits(jlift.enrichment_p_value_exact(jprobs, k))
        assert _bits(lift.enrichment_p_value_approximation(probs, k)) == \
            _bits(jlift.enrichment_p_value_approximation(jprobs, k))
        for upper in (True, False):
            assert _bits(lift.enrichment_p_value_bound(
                p[e1], p[e2], p[space], k, upper)) == _bits(
                jlift.enrichment_p_value_bound(j[e1], j[e2], j[space], k,
                                               upper))


def test_enrichment_exact_against_convolution():
    """The exact DP's pmf total, mean and tails against numpy's
    convolution of the Poisson-binomial, at n = 100."""
    rng = np.random.default_rng(2901)
    probs = rng.uniform(0.001, 0.4, 100).tolist()
    pmf = np.array([1.0])
    for q in probs:
        pmf = np.convolve(pmf, [1 - q, q])
    for k in (0, 10, 17, 40, 100):
        got = lift.enrichment_p_value_exact(probs, k)
        assert _bits(got) == _bits(jlift.enrichment_p_value_exact(probs, k))
        want = [pmf.sum(), float(np.arange(101) @ pmf), pmf[k:].sum(),
                pmf[:k + 1].sum()]
        assert np.allclose(got, want, rtol=1e-9, atol=1e-300)


def test_go_read_names_any_vcf(files, tmp_path):
    """go_read takes any name holding ".vcf" for a VCF."""
    path = tmp_path / "x.vcf.txt"
    path.write_bytes(open(files["lift_vcf"], "rb").read())
    got, want = lift.go_read(str(path)), jlift.go_read(str(path))
    assert _bed_vars(got) == _bed_vars(want)
    spans = {(r.chrom_start, r.chrom_end) for r in got if r.chrom == "chr1"}
    assert (2001, 2003) in spans and (2000, 2001) not in spans
