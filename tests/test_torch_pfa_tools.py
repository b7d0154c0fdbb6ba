"""The port's pFaTools and pfaFindFast (gonomics_tpu_torch/cli/pfa_tools.py,
pfa_find_fast.py) with ``numbers/gomath.py``, ``pdna.py``,
``io/pfasta.py`` and ``browser.py``'s pFa views, on the CPU against the
JAX package.

The inputs are built here from numpy seeds: three-record probabilistic
alignments (a reference, a first and a second query: bases one-hot or
blurred towards a Dirichlet draw, gap runs, N rows), a two-record FASTA
with lower case, N and gaps, single-record FASTAs, VCFs with genotype
columns (phased, unphased, missing and half-missing calls) and beds. Go's
``Log``/``Log2`` copies are held to the JAX's by the bits of their
results; the pDna functions' arrays by their bits; every pFaTools
subcommand's files and pfaFindFast's output by their bytes over their
flags, and every exit's message; ``sample`` under the same ``-setseed``.
"""

import ast
import gzip
import math
import os

import numpy as np
import pytest

import chip_smoke
from gonomics_tpu import browser as jbrowser
from gonomics_tpu import pdna as jpdna
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import pfasta as jpfasta
from gonomics_tpu.numbers import gomath as jgomath
from gonomics_tpu_torch import browser, pdna
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.io import bed, fasta, pfasta
from gonomics_tpu_torch.numbers import gomath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float64).view(np.uint64)


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, IndexError, KeyError) as e:
        return type(e).__name__, str(e)


def _files(d: str) -> dict:
    """Every file under d by its path relative to d, as bytes (a .gz
    file's decompressed: gzip's header carries the time)."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as fh:
                data = fh.read()
            out[os.path.relpath(path, d)] = (gzip.decompress(data)
                                             if n.endswith(".gz") else data)
    return dict(sorted(out.items()))


def _both(tmp_path, capsys, argv):
    """Runs both umbrellas with argv(d) in a directory of their own; the
    outcome, files and stdout of the two must be equal. Returns the JAX
    side's."""
    got = {}
    for side, umbrella in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir()
        res = _outcome(umbrella.main, argv(str(d)))
        got[side] = (res, _files(str(d)), capsys.readouterr().out)
    assert got["port"] == got["jax"]
    return got["jax"]


def soft_rows(rng, bases, soft=0.4, blur=0.6):
    """One-hot rows of the base codes, a share soft of them blurred by up
    to blur towards a Dirichlet draw; float32."""
    rows = np.zeros((len(bases), 4), np.float32)
    rows[np.arange(len(bases)), bases] = 1
    sel = rng.random(len(bases)) < soft
    e = rng.uniform(0, blur, (int(sel.sum()), 1))
    mix = rng.dirichlet(np.ones(4), int(sel.sum()))
    rows[sel] = ((1 - e) * rows[sel] + e * mix).astype(np.float32)
    return rows


def gap_runs(rng, rows, runs, longest=6):
    """rows with `runs` gap runs of 1..longest zeroed."""
    for s in rng.integers(0, len(rows), runs):
        rows[s:s + int(rng.integers(1, longest + 1))] = 0
    return rows


def alignment(seed=3520, n=600):
    """A reference and two queries of n columns: the second differs from
    the first at ~8% of the bases; gap runs in all three, N rows in both
    queries, a few all-zero columns at the start and end of the first."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, n)
    other = np.where(rng.random(n) < 0.08, (base + rng.integers(1, 4, n)) % 4,
                     base)
    ref = gap_runs(rng, soft_rows(rng, base, soft=0.0), 8)
    first = gap_runs(rng, soft_rows(rng, base), 10)
    second = gap_runs(rng, soft_rows(rng, other), 12)
    first[:3] = first[-2:] = 0
    for rows in (first, second):
        rows[rng.integers(0, n, 6)] = 0.25
    return {"chrA": ref, "first": first, "second": second}


def write_pfa(path, records: dict) -> str:
    chip_smoke.write_pfa(str(path), records)
    return str(path)


def write_fasta(path, records: dict) -> str:
    with open(path, "w") as fh:
        for name, s in records.items():
            fh.write(f">{name}\n" + "".join(s[i:i + 60] + "\n"
                                            for i in range(0, len(s), 60)))
    return str(path)


def vcf_text(sites, samples=4, seed=3521):
    """VCF lines for (chrom, pos, ref, alt) sites with seeded genotypes,
    among them phased, missing and half-missing calls."""
    rng = np.random.default_rng(seed)
    calls = ["0/0", "0/1", "1/1", "1|0", "0|1", "./.", "0/."]
    out = ["##fileformat=VCFv4.2",
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           + "\t".join(f"s{i}" for i in range(samples))]
    for c, p, r, a in sites:
        gts = rng.choice(calls, samples, p=[.2, .3, .2, .1, .1, .05, .05])
        out.append(f"{c}\t{p}\t.\t{r}\t{a}\t.\t.\t.\tGT\t" + "\t".join(gts))
    return "".join(ln + "\n" for ln in out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pfa")
    rng = np.random.default_rng(3522)
    aln = alignment()
    one = {"solo": soft_rows(rng, rng.integers(0, 4, 137))}
    seq = "".join(rng.choice(list("ACGT"), 400))
    lower = seq[:50] + seq[50:90].lower() + "NNNN" + seq[94:200] + "--" \
        + seq[202:]
    ref1 = "".join(rng.choice(list("ACGT"), 300))
    sites = [("chr1", p, ref1[p - 1], "ACGT"[("ACGT".index(ref1[p - 1]) + 1)
                                             % 4])
             for p in (3, 17, 40, 41, 99, 150, 299)]
    f = {"aln.pfa": write_pfa(d / "aln.pfa", aln),
         "one.pfa": write_pfa(d / "one.pfa", one),
         "two.fa": write_fasta(d / "two.fa", {"chrL": lower,
                                               "chrS": seq[:77]}),
         "one.fa": write_fasta(d / "one.fa", {"chrL": lower}),
         "ref1.fa": write_fasta(d / "ref1.fa", {"chr1": ref1}),
         "short.pfa": write_pfa(d / "short.pfa", {
             k: v[:-1] if k == "second" else v for k, v in aln.items()})}
    vcfs = {"g.vcf": sites,
            "unsorted.vcf": [sites[2], sites[1]],
            "multi.vcf": [("chr1", 5, ref1[4], "A,C")],
            "indel.vcf": [("chr1", 5, ref1[4:6], ref1[4])],
            "chrom.vcf": [("chr2", 5, ref1[4], "A")],
            "refbad.vcf": [("chr1", 5, "ACGT"[("ACGT".index(ref1[4]) + 1)
                                             % 4], ref1[4])]}
    for name, s in vcfs.items():
        (d / name).write_text(vcf_text(s))
        f[name] = str(d / name)
    (d / "regions.bed").write_text(
        "chrA\t0\t10\nfirst\t5\t55\nsecond\t100\t101\nfirst\t590\t600\n")
    (d / "badchrom.bed").write_text("chrA\t0\t10\nnope\t1\t3\n")
    f["regions.bed"] = str(d / "regions.bed")
    f["badchrom.bed"] = str(d / "badchrom.bed")
    f["aln"] = aln
    return f


JAX_PUBLIC = {
    "numbers/gomath.py": None, "pdna.py": None, "io/pfasta.py": None,
    "cli/pfa_tools.py": None, "cli/pfa_find_fast.py": None,
    "browser.py": {"pfa_visualizer", "pfa_visualizer_tsv"}}


def _names(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("rel", sorted(JAX_PUBLIC))
def test_module_defines_the_jax_public_names(rel):
    """Each module defines every public name of its JAX file (browser.py
    those of its pFa part)."""
    want = JAX_PUBLIC[rel] or _names(os.path.join(REPO, "gonomics_tpu", rel))
    assert want <= _names(os.path.join(REPO, "gonomics_tpu_torch", rel))


def _sweep() -> np.ndarray:
    """Powers of two over the whole exponent range, subnormals, their
    neighbours, 0, -0, 1, negatives, infinities, NaN, float32
    probabilities and float64 values over many exponents, all seeded."""
    rng = np.random.default_rng(3523)
    pow2 = np.ldexp(1.0, np.arange(-1074, 1024))
    sub = np.float64(5e-324) * rng.integers(1, 2 ** 52, 200).astype(
        np.float64)
    near = np.concatenate([np.nextafter(pow2[::7], np.inf),
                           np.nextafter(pow2[::7], 0)])
    probs = rng.random(3000).astype(np.float32).astype(np.float64)
    wide = rng.random(3000) * np.ldexp(1.0, rng.integers(-1000, 1000, 3000))
    f16 = np.arange(1, 2 ** 15, 3, dtype=np.uint16).view(np.float16)
    special = np.array([0.0, -0.0, 1.0, -1.0, -2.5, np.inf, -np.inf,
                        np.nan, 0.5, 0.25, 0.75, 1 / 3, math.sqrt(2) / 2])
    return np.concatenate([pow2, sub, near, probs, wide,
                           f16[np.isfinite(f16)].astype(np.float64),
                           special])


@pytest.mark.parametrize("name", ["go_log", "go_log2"])
def test_go_log_bits(name):
    """go_log and go_log2 equal the JAX's by the bits of every result
    (NaN where it is NaN) over the sweep."""
    xs = _sweep()
    got = np.array([getattr(gomath, name)(float(x)) for x in xs])
    want = np.array([getattr(jgomath, name)(float(x)) for x in xs])
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(_bits(got[~nan]), _bits(want[~nan]))


def test_go_log2_exact_powers_and_ulps():
    """go_log2 is exact on powers of two, and differs from math.log2 in
    the last place somewhere over the probabilities (so the entropy's
    bits hang on it)."""
    for e in range(-1074, 1024):
        assert gomath.go_log2(math.ldexp(1.0, e)) == e
    probs = np.random.default_rng(3524).random(5000)
    assert any(gomath.go_log2(float(p)) != math.log2(float(p))
               for p in probs)


def test_pdna_functions_bits(files):
    """Every pDna function on the alignment's rows (and a row pair a
    query) equals the JAX's, floats by their bits."""
    a = files["aln"]
    p, q = a["first"], a["second"]
    for fn in ("is_gap", "is_n"):
        assert np.array_equal(getattr(pdna, fn)(p), getattr(jpdna, fn)(p))
    for t in (0.5, 0.8, 0.25, 1.0):
        assert np.array_equal(pdna.is_confident(q, t),
                              jpdna.is_confident(q, t))
    assert np.array_equal(_bits(pdna.entropy(q)), _bits(jpdna.entropy(q)))
    assert pdna.entropy(q.reshape(-1, 2, 4)).shape == (300, 2)
    for fn in ("dot", "dot_subst_prob", "dist"):
        assert np.array_equal(_bits(getattr(pdna, fn)(p, q)),
                              _bits(getattr(jpdna, fn)(p, q)))
    codes = np.array([0, 1, 2, 3, 4, 10, 0, 4], np.int8)
    assert np.array_equal(pdna.dna_to_pdna(codes), jpdna.dna_to_pdna(codes))
    for bad in ([0, 5], [11], [12, 1]):
        assert _outcome(pdna.dna_to_pdna, np.array(bad, np.int8)) == \
            _outcome(jpdna.dna_to_pdna, np.array(bad, np.int8))


def _pf(module, records):
    return [module.PFasta(k, v.copy()) for k, v in records.items()]


def test_pfasta_to_map_and_all_are_equal(files):
    a = files["aln"]
    t, j = _pf(pfasta, a), _pf(jpfasta, a)
    assert {k: v.tobytes() for k, v in pfasta.to_map(t).items()} == \
        {k: v.tobytes() for k, v in jpfasta.to_map(j).items()}
    moved = {k: v + np.float32(1e-4) * (v > 0) for k, v in a.items()}
    for other in (a, moved, dict(list(a.items())[:2]),
                  {**a, "first": a["first"][:-1]}, {"x": a["chrA"]}):
        for prec in (1e-2, 1e-6):
            assert pfasta.all_are_equal(t, _pf(pfasta, other), prec) == \
                jpfasta.all_are_equal(j, _pf(jpfasta, other), prec)


@pytest.mark.parametrize("args", [
    (0, 10, "", "first", False), (5, 600, "out", "first", False),
    (5, 60, "out", "second", True), (10, 10, "", "first", False),
    (-1, 4, "", "first", False), (3, 601, "", "first", False),
    (0, 4, "", "nope", False)])
def test_pfasta_extract(files, args):
    """extract's record, or its error, equals the JAX's."""
    a = files["aln"]
    got = _outcome(pfasta.extract, _pf(pfasta, a), *args)
    want = _outcome(jpfasta.extract, _pf(jpfasta, a), *args)
    if got[0] == "ok":
        got = (got[1].name, got[1].seq.tobytes())
        want = (want[1].name, want[1].seq.tobytes())
    assert got == want


def test_pfasta_extract_bed_and_sample(files):
    a = files["aln"]
    regions = bed.read(files["regions.bed"])
    jregions = jbed.read(files["regions.bed"])
    for coords in (False, True):
        got = pfasta.extract_bed(_pf(pfasta, a), regions, coords)
        want = jpfasta.extract_bed(_pf(jpfasta, a), jregions, coords)
        assert [(r.name, r.seq.tobytes()) for r in got] == \
            [(r.name, r.seq.tobytes()) for r in want]
    rt, rj = np.random.default_rng(9), np.random.default_rng(9)
    for chrom in ("second", "first", "second"):
        got = pfasta.sample(_pf(pfasta, a), chrom, rt)
        want = jpfasta.sample(_pf(jpfasta, a), chrom, rj)
        assert (got.name, got.seq.tobytes()) == (want.name, want.seq.tobytes())
    assert rt.bit_generator.state == rj.bit_generator.state
    assert _outcome(pfasta.sample, _pf(pfasta, a), "nope", rt) == \
        _outcome(jpfasta.sample, _pf(jpfasta, a), "nope", rj)


@pytest.mark.parametrize("start,end", [(0, -1), (3, 200), (0, 10_000),
                                       (45, 100)])
def test_pfasta_fa_to_pfa(files, start, end):
    """fa_to_pfa of a record with lower case, N and gaps (one-hot, 0.25,
    zeros) equals the JAX's, or its error."""
    t = fasta.read(files["two.fa"])[0]
    j = jfasta.read(files["two.fa"])[0]
    got = _outcome(pfasta.fa_to_pfa, t, start, end)
    want = _outcome(jpfasta.fa_to_pfa, j, start, end)
    if got[0] == "ok":
        got, want = ((r[1].name, r[1].seq.tobytes()) for r in (got, want))
    assert got == want


@pytest.mark.parametrize("fa,chrom", [
    ("one.fa", ""), ("one.fa", "chrL"), ("one.fa", "chrX"), ("two.fa", ""),
    ("two.fa", "chrS"), ("two.fa", "chrX")])
def test_pfasta_multi_fa_to_pfa(files, fa, chrom):
    got = _outcome(pfasta.multi_fa_to_pfa, files[fa], 2, 40, chrom)
    want = _outcome(jpfasta.multi_fa_to_pfa, files[fa], 2, 40, chrom)
    if got[0] == "ok":
        got, want = ((r[1].name, r[1].seq.tobytes()) for r in (got, want))
    assert got == want


@pytest.mark.parametrize("vcf,fa,start,end", [
    ("g.vcf", "ref1.fa", 0, 300), ("g.vcf", "ref1.fa", 0, -1),
    ("g.vcf", "ref1.fa", 0, 100), ("g.vcf", "ref1.fa", 2, 120),
    ("unsorted.vcf", "ref1.fa", 0, 300), ("multi.vcf", "ref1.fa", 0, 300),
    ("indel.vcf", "ref1.fa", 0, 300), ("chrom.vcf", "ref1.fa", 0, 300),
    ("refbad.vcf", "ref1.fa", 0, 300), ("g.vcf", "two.fa", 0, 300)])
def test_pfasta_vcf_to_pfa(files, vcf, fa, start, end):
    """vcf_to_pfa's record (genotype shares at the sites; with the
    default end of -1 no site, as in the JAX) or its error equals the
    JAX's."""
    got = _outcome(pfasta.vcf_to_pfa, files[vcf], files[fa], start, end)
    want = _outcome(jpfasta.vcf_to_pfa, files[vcf], files[fa], start, end)
    if got[0] == "ok":
        got, want = ((r[1].name, r[1].seq.tobytes()) for r in (got, want))
    assert got == want


def _pfa_cases():
    a, o = "aln.pfa", "one.pfa"
    return {
        "entropy": ["entropyTrack", a, "ent.wig"],
        "entropy_default0": ["entropyTrack", "-defaultValue", "0", a,
                             "ent.wig"],
        "entropy_gz": ["entropyTrack", o, "ent.wig.gz"],
        "extract": ["extract", a, "second", "10", "300", "ex.pfa"],
        "extract_name": ["extract", "-outName", "x", a, "first", "0", "600",
                         "ex.pfa"],
        "extract_order": ["extract", a, "first", "30", "30", "ex.pfa"],
        "extract_range": ["extract", a, "first", "30", "700", "ex.pfa"],
        "extract_chrom": ["extract", a, "nope", "0", "3", "ex.pfa"],
        "extract_bed": ["extractBed", a, "@regions.bed", "exb.pfa"],
        "extract_bed_coords": ["extractBed", "-takeCoords", a,
                               "@regions.bed", "exb.pfa"],
        "extract_bed_chrom": ["extractBed", a, "@badchrom.bed", "exb.pfa"],
        "sample": ["sample", a, "second", "."],
        "sample_seeded": ["sample", "-numSamples", "3", "-setseed", "5", a,
                          "first", "."],
        "sample_chrom": ["sample", a, "nope", "."],
        "visualize": ["visualize", "-chrom", "second", a, "0", "120",
                      "vis.txt"],
        "visualize_words": ["visualize", "-chrom", "first", "-lineLength",
                            "7", a, "start", "END", "vis.txt"],
        "visualize_sig": ["visualize", "-sigFigs", "3", o, "5", "50",
                          "vis.txt"],
        "visualize_decimal": ["visualize", "-decimal", "2", o, "0", "-1",
                              "vis.txt"],
        "visualize_tsv": ["visualize", "-tsvOut", o, "0", "37", "vis.tsv"],
        "visualize_tsv_chrom": ["visualize", "-tsvOut", "-sigFigs", "4",
                                "-chrom", "second", a, "100", "131",
                                "vis.tsv"],
        "visualize_tsv_end": ["visualize", "-tsvOut", "-chrom", "first", a,
                              "Start", "end", "vis.tsv"],
        "visualize_order": ["visualize", "-chrom", "first", a, "9", "9",
                            "vis.txt"],
        "visualize_negative": ["visualize", o, "-5", "9", "vis.txt"],
        "visualize_many": ["visualize", a, "0", "9", "vis.txt"],
        "visualize_missing": ["visualize", "-chrom", "nope", a, "0", "9",
                              "vis.txt"],
        "fa_to_pfa": ["faToPfa", "@one.fa", "f.pfa"],
        "fa_to_pfa_range": ["faToPfa", "-start", "5", "-end", "250",
                            "-chrom", "chrL", "@two.fa", "f.pfa"],
        "fa_to_pfa_chrom": ["faToPfa", "@two.fa", "f.pfa"],
        "fa_to_pfa_end": ["faToPfa", "-end", "5000", "@one.fa", "f.pfa"],
        "vcf_to_pfa": ["vcfToPfa", "-end", "300", "@g.vcf", "@ref1.fa",
                       "v.pfa"],
        "vcf_to_pfa_default": ["vcfToPfa", "@g.vcf", "@ref1.fa", "v.pfa"],
        "vcf_to_pfa_start": ["vcfToPfa", "-start", "2", "-end", "120",
                             "@g.vcf", "@ref1.fa", "v.pfa"],
        "vcf_to_pfa_unsorted": ["vcfToPfa", "-end", "300", "@unsorted.vcf",
                                "@ref1.fa", "v.pfa"],
        "vcf_to_pfa_multi": ["vcfToPfa", "-end", "300", "@multi.vcf",
                             "@ref1.fa", "v.pfa"],
        "no_subcommand": [],
        "unknown": ["entropy", a, "x.wig"],
    }


@pytest.mark.parametrize("case", sorted(_pfa_cases()))
def test_pfa_tools_equal_jax(files, tmp_path, capsys, case):
    """Each pFaTools subcommand's files, stdout and exit message equal the
    JAX tool's; '@name' stands for a fixture file, a bare name for a file
    in the side's directory (the inputs are copied there)."""
    argv = _pfa_cases()[case]

    def paths(d):
        for name in ("aln.pfa", "one.pfa"):
            with open(files[name], "rb") as src, \
                    open(os.path.join(d, name), "wb") as dst:
                dst.write(src.read())
        out = []
        for x in argv:
            if x.startswith("@"):
                out.append(files[x[1:]])
            elif "." in x and not x.replace(".", "").isdigit() \
                    and x != ".":
                out.append(os.path.join(d, x))
            elif x == ".":
                out.append(d)
            else:
                out.append(x)
        return ["pFaTools"] + out

    res, produced, _ = _both(tmp_path, capsys, paths)
    if case in ("entropy", "extract", "sample_seeded", "visualize_tsv",
                "vcf_to_pfa", "fa_to_pfa_range", "extract_bed_coords"):
        assert res[0] == "ok" and len(produced) > 2


def _ff_cases():
    n = ["-firstQueryName", "first", "-secondQueryName", "second"]
    w = ["-windowSize", "20", "-chrom", "chrA"]
    return {
        "default": [],
        "named": n + w,
        "long": n + w + ["-longOutput"],
        "long_rate": n + w + ["-longOutput", "-divergenceRate", "0.05"],
        "remove_n": n + w + ["-removeN"],
        "aln_pos": n + w + ["-outputAlnPos"],
        "all": n + w + ["-longOutput", "-divergenceRate", "0.2", "-removeN",
                        "-outputAlnPos"],
        "swapped": ["-firstQueryName", "second", "-secondQueryName", "first",
                    "-windowSize", "35", "-longOutput", "-outputAlnPos"],
        "thresholds": n + w + ["-longOutput", "-baseDotToSubstThreshold",
                               "0.5", "-confidentThreshold", "0.95"],
        "window_past_end": n + ["-windowSize", "5000"],
        "first_missing": ["-firstQueryName", "nope"],
        "second_missing": ["-secondQueryName", "nope"],
        "rate_range": ["-divergenceRate", "2"],
        "lengths": ["@short.pfa"],
        "one_record": ["@one.pfa"],
    }


@pytest.mark.parametrize("case", sorted(_ff_cases()))
def test_pfa_find_fast_equals_jax(files, tmp_path, capsys, case):
    """pfaFindFast's bed bytes and exit messages equal the JAX tool's:
    short and long output, with and without -divergenceRate, -removeN
    and -outputAlnPos, the queries by name or by default (the reference
    as the first query), the thresholds moved."""
    flags = _ff_cases()[case]
    inp = files["aln.pfa"]
    if flags and flags[0].startswith("@"):
        inp, flags = files[flags[0][1:]], flags[1:]
    res, produced, _ = _both(tmp_path, capsys, lambda d: [
        "pfaFindFast", inp, os.path.join(d, "out.bed"), *flags])
    if case in ("named", "long_rate", "all"):
        assert res[0] == "ok" and produced["out.bed"].count(b"\n") > 100


@pytest.mark.parametrize("tsv", [False, True], ids=["blocks", "tsv"])
@pytest.mark.parametrize("args", [
    (0, 45, False, False, 0, 5, 10, "second"),
    (7, -1, False, True, 2, 5, 13, "first"),
    (0, 0, True, True, 0, 3, 50, "chrA"),
    (4, 30, False, False, 0, 5, 6, ""),
    (9, 3, False, False, 0, 5, 6, "first"),
    (-2, 3, False, False, 0, 5, 6, "first")])
def test_browser_pfa_views(files, tmp_path, args, tsv):
    """pfa_visualizer and pfa_visualizer_tsv write the JAX's bytes (the
    single-record tsv's end one past, as the JAX does) or raise its
    error."""
    start, end, s_aln, e_aln, sig, dec, width, name = args
    src = files["one.pfa"] if name == "" else files["aln.pfa"]
    got = {}
    for side, mod in (("jax", jbrowser), ("port", browser)):
        fn = mod.pfa_visualizer_tsv if tsv else mod.pfa_visualizer
        out = tmp_path / f"{side}.txt"
        res = _outcome(fn, src, str(out), start, end, s_aln, e_aln, sig,
                       dec, width, name)
        got[side] = (res, out.read_bytes() if out.exists() else None)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("fault", [None, "trailing_rows", "repeated_name",
                                   "header_long"])
def test_chip_smoke_pfa_records_is_strict(tmp_path, fault):
    """chip_smoke.pfa_records, which its pFa and ILS gates read through,
    gives back write_pfa's records and raises ValueError where rows
    follow the last record, a record's name repeats or the header asks
    for more rows than the file holds."""
    rng = np.random.default_rng(3510)
    recs = {"a": rng.random((5, 4)).astype(np.float32),
            "b": rng.random((3, 4)).astype(np.float32)}
    path = tmp_path / "r.pfa"
    chip_smoke.write_pfa(str(path), recs)
    data = path.read_bytes()
    if fault == "trailing_rows":
        data += np.ones((2, 4), "<f2").tobytes()
    elif fault == "repeated_name":
        data = data.replace(b"b\t3\n", b"a\t3\n")
    elif fault == "header_long":
        data = data.replace(b"b\t3\n", b"b\t4\n")
    path.write_bytes(data)
    if fault is None:
        got = chip_smoke.pfa_records(str(path))
        assert list(got) == ["a", "b"]
        for k, v in recs.items():
            assert np.array_equal(got[k], v.astype("<f2").astype(np.float32))
    else:
        with pytest.raises(ValueError):
            chip_smoke.pfa_records(str(path))
