"""The port's VCF tools of item 10 (``sampleVcf``, ``proximityBlockVcf``,
``filterGenotypes``, ``vcfAncestorAnnotation``, ``vcfAfs``,
``haplotypeGenerator``, gonomics_tpu_torch/cli/vcf_sampling.py, and
``alleleSplit``, cli/allele_split.py) on the CPU against the JAX tools:
the bytes of every file they write, their stdout, and the message of
every exit, on inputs that a numpy seed builds here: a reference of
chr1, chr2 and chr10, a genotype VCF of five samples (a trio among them)
with phased, unphased, haploid, missing and multi-allelic calls, SNPs,
indels and gap-written deletions, a two-row alignment with gap runs, a
SAM of reads with M, I, D and S over the trio's sites, and popgen's AFS
VCFs. Each quirk of the reference that the port keeps is pinned by a
case here. Also the library under them: ``io/vcf``'s sample-list and
ancestor helpers, and every function of ``genotype`` (the batch caller
at ``device="cpu"``) against the JAX's, floats by their 64 bits.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from gonomics_tpu import genotype as jgeno
from gonomics_tpu import pileup as jpileup
from gonomics_tpu.cli import allele_split as jallele
from gonomics_tpu.cli import vcf_sampling as jvs
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import vcf as jvcf
from gonomics_tpu_torch import genotype as geno
from gonomics_tpu_torch import pileup
from gonomics_tpu_torch.cli import allele_split
from gonomics_tpu_torch.cli import vcf_sampling as vs
from gonomics_tpu_torch.io import fasta, vcf

from test_torch_popgen import popgen_vcf

TOOLS = {"sampleVcf": (jvs.main_sample, vs.main_sample),
         "proximityBlockVcf": (jvs.main_proximity, vs.main_proximity),
         "filterGenotypes": (jvs.main_filter_genotypes,
                             vs.main_filter_genotypes),
         "vcfAncestorAnnotation": (jvs.main_ancestor, vs.main_ancestor),
         "vcfAfs": (jvs.main_afs, vs.main_afs),
         "haplotypeGenerator": (jvs.main_haplotype, vs.main_haplotype),
         "alleleSplit": (jallele.main, allele_split.main)}

SIZES = [("chr1", 900), ("chr2", 400), ("chr10", 300)]
SAMPLES = ["momma", "poppa", "kiddo", "s4", "s5"]
GTS = ["0/0", "0/1", "1/1", "1|0", "0|1", "1/2", "2/2", "./.", "0", "0/.",
       "1|1"]


def _both(tmp_path, tool: str, argv, chdir=None) -> dict:
    """Runs the JAX tool and the port's with argv(d), d a directory of
    each side's own (the working directory too where chdir is a pytest
    monkeypatch), and holds their exits, stdout and the files they wrote
    under d equal; returns the port's {"exit": message or None,
    "stdout": text, "files": {path under d: bytes}}."""
    seen = {}
    for side, main in zip(("jax", "port"), TOOLS[tool]):
        d = tmp_path / side
        d.mkdir()
        if chdir is not None:
            chdir.chdir(d)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                main(argv(str(d)))
            exit_msg = None
        except SystemExit as e:
            exit_msg = str(e)
        except Exception as e:  # the JAX tools' KeyError, IndexError, ...
            exit_msg = f"{type(e).__name__}: {e}"
        files = {}
        for root, _, names in os.walk(d):
            for n in names:
                path = os.path.join(root, n)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, d)] = f.read()
        seen[side] = {"exit": exit_msg, "stdout": buf.getvalue(),
                      "files": files}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _write(path, lines) -> str:
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in lines)
    return str(path)


def _genome(rng) -> dict:
    return {c: "".join(rng.choice(list("ACGT"), n)) for c, n in SIZES}


HEAD = ["##fileformat=VCFv4.2",
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(SAMPLES)]


def _genotype_rows(rng, genome: dict, n: int) -> list[str]:
    """n records over the genome: mostly single-base SNPs (one or two
    ALTs), some multi-base REF or ALT, a few gap-written deletions, some
    with a GT:DP format; genotypes drawn from GTS, with planted trio
    sites (momma 0/0, poppa 1/1, kiddo 0/1 and the mirror) and sites
    failing the trio test."""
    rows = []
    trio = [("0/0", "1/1", "0/1"), ("1/1", "0/0", "1/0"),
            ("0/0", "0/0", "0/1"), ("2/2", "1/1", "1/2"),
            ("0/0", "1/1", "1/1"), ("0|0", "1|1", "1|0")]
    for i in range(n):
        chrom, size = SIZES[int(rng.integers(0, len(SIZES)))]
        pos = int(rng.integers(1, size - 4))
        ref = genome[chrom][pos - 1]
        kind = rng.random()
        others = [b for b in "ACGT" if b != ref]
        if kind < 0.65:
            alt = str(rng.choice(others))
        elif kind < 0.8:
            alt = ",".join(rng.choice(others, 2, replace=False))
        elif kind < 0.9:
            ref = genome[chrom][pos - 1:pos + 2]
            alt = ref[0]
        elif kind < 0.95:
            alt = ref + "T"
        else:
            ref = genome[chrom][pos - 1:pos + 1]
            alt = "--"
        if i % 4 == 0:
            gts = list(trio[(i // 4) % len(trio)])
        else:
            gts = [str(rng.choice(GTS[:7])) for _ in range(3)]
        gts += [str(rng.choice(GTS)) for _ in range(2)]
        with_dp = rng.random() < 0.3
        fmt = "GT:DP" if with_dp else "GT"
        if with_dp:
            gts = [f"{g}:{int(rng.integers(1, 40))}" for g in gts]
        info = "." if rng.random() < 0.5 else f"DP={int(rng.integers(1, 99))}"
        rows.append((chrom, pos, f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t30\tPASS\t"
                     f"{info}\t{fmt}\t" + "\t".join(gts)))
    rows.sort(key=lambda r: (r[0], r[1]))
    return [r[2] for r in rows]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcf_sampling")
    rng = np.random.default_rng(3001)
    genome = _genome(rng)
    rows = _genotype_rows(rng, genome, 90)
    files = {
        "ref.fa": [x for c, _ in SIZES for x in (f">{c}", genome[c])],
        "g.vcf": HEAD + rows,
        "bare.vcf": rows[:12],
        "nochrom.vcf": HEAD[:2] + rows[:12],
        "empty.vcf": HEAD,
        "sites.vcf": HEAD[:1]
        + ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
        + ["\t".join(r.split("\t")[:8]) for r in rows[:30]],
        "names.txt": ["s5", "momma", "kiddo"],
        "bad_names.txt": ["kiddo", "nobody"],
        "regions.bed": ["chr1\t0\t300", "chr1\t250\t700", "chr2\t10\t390",
                        "chr10\t0\t300", "chrZ\t5\t60"],
    }
    out = {k: _write(d / k, v) for k, v in files.items()}
    out["genome"] = genome
    return out


@pytest.mark.parametrize("args", [
    ["-numVariants", "10", "-setSeed", "7"],
    ["-numVariants", "90", "-setSeed", "0"],
    ["-numVariants", "25", "-numSamples", "3", "-setSeed", "11"],
    ["-numVariants", "5", "-numSamples", "5", "-setSeed", "2"],
    ["-numVariants", "91", "-setSeed", "1"],
    ["-numVariants", "4", "-numSamples", "6", "-setSeed", "1"]])
def test_sample_vcf(data, tmp_path, args):
    """Records from a PCG64 permutation at the seed, columns from a second
    permutation of the same generator, the header's names rewritten;
    exits on too many variants or samples."""
    got = _both(tmp_path, "sampleVcf",
                lambda d: [data["g.vcf"], d + "/out.vcf", *args])
    if got["exit"] is None:
        lines = got["files"]["out.vcf"].decode().splitlines()
        assert len([ln for ln in lines if not ln.startswith("#")]) == int(
            args[1])


@pytest.mark.parametrize("name,args", [
    ("bare.vcf", ["-numVariants", "6", "-numSamples", "2", "-setSeed", "3"]),
    ("nochrom.vcf", ["-numVariants", "6", "-setSeed", "3"]),
    ("sites.vcf", ["-numVariants", "8", "-setSeed", "9"])])
def test_sample_vcf_headers(data, tmp_path, name, args):
    """A VCF with no header lines keeps no header and still samples its
    columns; a header without a #CHROM line exits ("No Sample info");
    a sites-only VCF samples records alone."""
    got = _both(tmp_path, "sampleVcf",
                lambda d: [data[name], d + "/out.vcf", *args])
    if name == "nochrom.vcf":
        assert got["exit"].startswith("No Sample info in VCF line")
    else:
        assert got["exit"] is None


@pytest.mark.parametrize("distance,seed", [(1, 4), (50, 5), (200, 6),
                                           (100_000, 7)])
def test_proximity_block_vcf(data, tmp_path, distance, seed):
    got = _both(tmp_path, "proximityBlockVcf",
                lambda d: [data["g.vcf"], d + "/out.vcf", str(distance),
                           "-setSeed", str(seed)])
    rows = [ln.split("\t") for ln in
            got["files"]["out.vcf"].decode().splitlines()
            if not ln.startswith("#")]
    for i, a in enumerate(rows):
        assert all(a[0] != b[0] or abs(int(a[1]) - int(b[1])) >= distance
                   for b in rows[:i])


def test_proximity_block_vcf_empty_raises(data, tmp_path):
    got = _both(tmp_path, "proximityBlockVcf",
                lambda d: [data["empty.vcf"], d + "/out.vcf", "10",
                           "-setSeed", "1"])
    assert got["exit"].startswith("IndexError")


@pytest.mark.parametrize("args", [
    ["-f1", "kiddo", "-parentOne", "momma", "-parentTwo", "poppa"],
    ["-f1", "kiddo", "-parentOne", "poppa", "-parentTwo", "momma"],
    ["-f1", "s4", "-parentOne", "s5", "-parentTwo", "momma"],
    ["-f1", "kiddo", "-parentOne", "momma"],
    ["-f1", "kiddo", "-parentOne", "momma", "-parentTwo", "nobody"],
    ["-byname", "names.txt"], ["-byname", "bad_names.txt"]])
def test_filter_genotypes(data, tmp_path, args):
    """The trio filter (both parents homozygous for different alleles,
    the F1 heterozygous), the named columns in the names file's order,
    an unknown name's KeyError and the missing parent's exit."""
    argv = [data[a] if a in data else a for a in args]
    got = _both(tmp_path, "filterGenotypes",
                lambda d: [data["g.vcf"], d + "/out.vcf", *argv])
    if args[0] == "-byname" and args[1] == "names.txt":
        head = [ln for ln in got["files"]["out.vcf"].decode().splitlines()
                if ln.startswith("#CHROM")]
        assert head[0].split("\t")[9:] == ["s5", "momma", "kiddo"]
    if args[-1] == "poppa" and args[3] == "momma":
        kept = [ln for ln in got["files"]["out.vcf"].decode().splitlines()
                if not ln.startswith("#")]
        assert kept


def _alignment(rng, n: int) -> tuple[str, str]:
    """A reference row of n bases with gap runs of 1-4 every ~25 columns,
    and an ancestor row (gaps where the reference has bases, now and
    then)."""
    ref, anc = [], []
    while sum(c != "-" for c in ref) < n:
        ref.append(str(rng.choice(list("ACGTacgt"))))
        anc.append(str(rng.choice(list("ACGT-"), p=[.24, .24, .24, .24, .04])))
        if rng.random() < 0.04:
            k = int(rng.integers(1, 5))
            ref += ["-"] * k
            anc += [str(x) for x in rng.choice(list("ACGT"), k)]
    return "".join(ref), "".join(anc)


@pytest.mark.parametrize("case", ["sorted", "other_chrom", "backwards",
                                  "past_end"])
def test_vcf_ancestor_annotation(tmp_path, case):
    """AA= is the ancestor row's base at the record's column, run over
    the reference row's gaps after it; INFO "." is replaced; no AA line
    joins the header; rows 0 and 1 serve every record whatever its
    chrom; positions going back raise ValueError, past the row's end
    IndexError."""
    rng = np.random.default_rng(3002)
    ref, anc = _alignment(rng, 420)
    src = tmp_path / "src"
    src.mkdir()
    aln = _write(src / "aln.fa", [">chr1", ref, ">anc", anc])
    bases = [c for c in ref if c != "-"]
    gapped = [i for i in range(1, len(bases))
              if ref[[j for j, c in enumerate(ref) if c != "-"][i - 1]
                     + 1] == "-"]
    pos = sorted(set(rng.integers(1, 400, 30).tolist() + gapped[:8]))
    rows = [f"chr1\t{p}\t.\t{bases[p - 1].upper()}\tA\t30\tPASS\t"
            f"{'.' if k % 2 else 'DP=3'}" for k, p in enumerate(pos)]
    if case == "other_chrom":
        rows += [f"chr9\t{p}\t.\tA\tC\t30\tPASS\t." for p in (405, 410)]
    elif case == "backwards":
        rows.insert(5, "chr1\t2\t.\tA\tC\t30\tPASS\t.")
    elif case == "past_end":
        rows.append("chr1\t422\t.\tA\tC\t30\tPASS\t.")
    vcf_in = _write(src / "in.vcf", ['##INFO=<ID=DP,Number=1,Type=Integer,'
                                     'Description="Depth">',
                                     "#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                                     "FILTER\tINFO"] + rows)
    got = _both(tmp_path, "vcfAncestorAnnotation",
                lambda d: [vcf_in, aln, d + "/out.vcf"])
    if case in ("sorted", "other_chrom"):
        assert got["exit"] is None
        text = got["files"]["out.vcf"].decode()
        assert "ID=AA" not in text and text.count("AA=") == len(rows)
    else:
        assert got["exit"].startswith("ValueError" if case == "backwards"
                                      else "IndexError")


@pytest.mark.parametrize("args", [
    [], ["-unPolarized"], ["-includeRef"],
    ["-plotSelectionLikelihood", "lik.tsv", "-leftBound", "-2",
     "-rightBound", "3", "-numberOfPoints", "2", "-integralError", "1e-5"],
    ["-plotSelectionLikelihood", "lik.tsv", "-leftBound", "-2",
     "-rightBound", "2", "-numberOfPoints", "2", "-integralError", "1e-5"]])
def test_vcf_afs(tmp_path, args):
    """i/n with :f a site, and the likelihood grid with :e over
    numberOfPoints + 1 alphas, at n <= 10; a grid point at alpha 0 exactly
    raises ValueError, its header and earlier rows written."""
    src = tmp_path / "src"
    src.mkdir()
    popgen_vcf(str(src / "p.vcf"), 3003, sites=12, samples=4)
    got = _both(tmp_path, "vcfAfs", lambda d: [
        str(src / "p.vcf"), d + "/afs.txt",
        *[d + "/" + a if a.endswith(".tsv") else a for a in args]])
    if args[5:6] == ["2"]:
        assert got["exit"] == "ValueError: alpha cannot be exactly zero"
    else:
        assert got["exit"] is None
    if args and args[0] == "-plotSelectionLikelihood":
        assert len(got["files"]["lik.tsv"].decode().splitlines()) == (
            2 if args[5:6] == ["2"] else 4)


def _diploid(line: str) -> bool:
    """Every sample's call has two alleles, none missing, each of the
    record's."""
    f = line.split("\t")
    gts = [x.split(":")[0] for x in f[9:]]
    return all(len(g) == 3 and "." not in g
               and max(int(g[0]), int(g[2])) <= len(f[4].split(","))
               for g in gts)


@pytest.mark.parametrize("args", [[], ["-includeRef"],
                                  ["-includeRef", "-lineLength", "70"]])
def test_haplotype_generator(data, tmp_path, args):
    """A file a region, <chrom>.<start>.<end>.fa, the reference first with
    -includeRef, then <sample>_A and <sample>_B with the sample's single-
    base alts inside the region; chrZ, absent from the FASTA, takes
    record 0's bases."""
    vcf_in = tmp_path / "hap.vcf"
    keep = [ln for ln in open(data["g.vcf"]).read().splitlines()
            if ln.startswith("#") or _diploid(ln)]
    _write(vcf_in, keep + ["chrZ\t20\t.\tA\tG\t30\tPASS\t.\tGT\t0/1\t1/1\t"
                           "0/0\t1|0\t0/1"])
    got = _both(tmp_path, "haplotypeGenerator", lambda d: [
        data["ref.fa"], str(vcf_in), data["regions.bed"], d, *args])
    assert got["exit"] is None
    assert sorted(got["files"]) == ["chr1.0.300.fa", "chr1.250.700.fa",
                                    "chr10.0.300.fa", "chr2.10.390.fa",
                                    "chrZ.5.60.fa"]
    first = got["files"]["chr1.0.300.fa"].decode().splitlines()
    names = [ln[1:] for ln in first if ln.startswith(">")]
    assert names == (["chr1"] if args else []) + [
        f"{s}_{h}" for s in SAMPLES for h in "AB"]
    z = got["files"]["chrZ.5.60.fa"].decode().split(">")
    s4_a, s4_b = ("".join(x.splitlines()[1:]) for x in z[-4:-2])
    assert s4_b == data["genome"]["chr1"][5:60]
    assert s4_a == s4_b[:14] + "G" + s4_b[15:]


@pytest.mark.parametrize("gt,err", [("./.", "TypeError"),
                                    ("1", "IndexError")])
def test_haplotype_generator_bad_call_raises(data, tmp_path, gt, err):
    """A missing call in a region raises TypeError, a haploid one
    IndexError (its second haplotype)."""
    vcf_in = tmp_path / "bad.vcf"
    _write(vcf_in, HEAD + [f"chr1\t20\t.\tA\tG\t30\tPASS\t.\tGT\t0/1\t"
                           f"{gt}\t0/0\t1|0\t0/1"])
    got = _both(tmp_path, "haplotypeGenerator", lambda d: [
        data["ref.fa"], str(vcf_in), data["regions.bed"], d])
    assert got["exit"].startswith(err)


# --- alleleSplit: a trio VCF and a SAM of reads over chr1 of its genome


def _trio_inputs(d, seed: int):
    """chr1 of 1,200 random bases; a VCF of trio SNPs (momma 0/0, poppa
    1/1, kiddo 0/1, or mirrored), decoys failing the trio test, and
    two-base deletions written as "--" ALTs; reads of 40-70 bp with
    M/I/D/S carrying one parent's allele at the sites they cover, none
    now and then (a tie), the deletions as 2D where poppa carries them,
    as 1D (no parent's gap count) now and then."""
    rng = np.random.default_rng(seed)
    g = "".join(rng.choice(list("ACGT"), 1200))
    sites = sorted(set(rng.integers(30, 1150, 60).tolist()))
    snps, dels, rows = {}, {}, []
    for k, p in enumerate(sites):
        ref = g[p - 1]
        if k % 7 == 3:
            rows.append(f"chr1\t{p}\t.\t{g[p - 1:p + 1]}\t--\t30\tPASS\t.\t"
                        "GT\t0/0\t1/1\t0/1")
            dels[p - 1] = 2
            continue
        alt = str(rng.choice([b for b in "ACGT" if b != ref]))
        if k % 5 == 4:  # a decoy: the parents agree
            rows.append(f"chr1\t{p}\t.\t{ref}\t{alt}\t30\tPASS\t.\tGT\t"
                        "0/0\t0/0\t0/1")
            continue
        mirror = k % 3 == 0
        gts = "1/1\t0/0\t1/0" if mirror else "0|0\t1|1\t0|1"
        rows.append(f"chr1\t{p}\t.\t{ref}\t{alt}\t30\tPASS\t.\tGT\t{gts}")
        # the base each parent carries
        snps[p - 1] = (alt, ref) if mirror else (ref, alt)
    vcf_path = _write(os.path.join(d, "trio.vcf"), [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tmomma\t"
        "poppa\tkiddo"] + rows)
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chr1\tLN:1200"]
    for i in range(150):
        start = int(rng.integers(0, 1100))
        parent = int(rng.integers(0, 3))  # 2: neither, a tie
        seq, cig, t = [], [], start
        if rng.random() < 0.2:
            n = int(rng.integers(1, 4))
            seq += list(rng.choice(list("ACGT"), n))
            cig.append(f"{n}S")
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(10, 30))
            n = min(n, 1200 - t)
            if n <= 0:
                break
            for j in range(t, t + n):
                if j in snps and parent < 2:
                    seq.append(snps[j][parent])
                elif j in snps:
                    seq.append("N")
                else:
                    seq.append(g[j] if rng.random() > 0.01 else "a")
            cig.append(f"{n}M")
            t += n
            if t in dels and t + 2 < 1200:
                size = 2 if parent == 1 or rng.random() < 0.3 else 1
                cig.append(f"{size}D")
                t += size
            elif rng.random() < 0.3 and t < 1190:
                kind = rng.random()
                if kind < 0.5:
                    cig.append("2I")
                    seq += list(rng.choice(list("ACGT"), 2))
                else:
                    cig.append("3D")
                    t += 3
        if not cig or cig[-1].endswith(("D", "I", "S")):
            cig.append("1M")
            seq.append(g[min(t, 1199)])
        lines.append(f"r{i}\t{16 * (i % 2)}\tchr1\t{start + 1}\t60\t"
                     f"{''.join(cig)}\t*\t0\t0\t{''.join(seq)}\t*")
    sam_path = _write(os.path.join(d, "reads.sam"), lines)
    return sam_path, vcf_path


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = tmp_path_factory.mktemp("trio")
    return _trio_inputs(str(d), 3004)


@pytest.mark.parametrize("args", [
    ["-f1", "kiddo", "-parentOne", "momma", "-parentTwo", "poppa"],
    ["-f1", "kiddo", "-parentOne", "poppa", "-parentTwo", "momma"],
    ["-parentOne", "momma", "-parentTwo", "poppa", "-f1", "kiddo",
     "-samples"]])
def test_allele_split(trio, tmp_path, monkeypatch, args):
    """Each read in <f1>.<parent>.SNPs.sam of its larger allele count, in
    the working directory, under the SAM's header; no file takes a tie."""
    sam, vcf_path = trio
    got = _both(tmp_path, "alleleSplit", lambda d: [*args, sam, vcf_path],
                chdir=monkeypatch)
    assert got["exit"] is None
    p1, p2 = args[args.index("-parentOne") + 1], args[args.index(
        "-parentTwo") + 1]
    names = {k: [ln.split("\t")[0] for ln in
                 got["files"][f"kiddo.{k}.SNPs.sam"].decode().splitlines()
                 if not ln.startswith("@")] for k in (p1, p2)}
    assert names[p1] and names[p2] and not set(names[p1]) & set(names[p2])
    assert len(names[p1]) + len(names[p2]) < 150


@pytest.mark.parametrize("case", ["samples", "samples_gz_name",
                                  "samples_not_vcf", "one_file", "no_f1",
                                  "no_parent_two", "unknown_name"])
def test_allele_split_args(trio, tmp_path, monkeypatch, case):
    """-samples prints the names for one file ending .vcf or vcf.gz, and
    nothing for another; the arguments error otherwise; an unknown name's
    KeyError."""
    sam, vcf_path = trio
    gz_name = str(tmp_path / "trio_copy.vcf.gz")
    import gzip
    with open(vcf_path, "rb") as f, gzip.open(gz_name, "wb") as g:
        g.write(f.read())
    argv = {"samples": ["-samples", vcf_path],
            "samples_gz_name": ["-samples", gz_name],
            "samples_not_vcf": ["-samples", sam],
            "one_file": ["-f1", "kiddo", "-parentOne", "momma",
                         "-parentTwo", "poppa", sam],
            "no_f1": ["-parentTwo", "poppa", sam, vcf_path],
            "no_parent_two": ["-f1", "kiddo", "-parentOne", "momma", sam,
                              vcf_path],
            "unknown_name": ["-f1", "kiddo", "-parentOne", "nobody",
                             "-parentTwo", "poppa", sam, vcf_path]}[case]
    got = _both(tmp_path, "alleleSplit", lambda d: argv, chdir=monkeypatch)
    if case.startswith("samples"):
        assert got["exit"] is None and got["files"] == {}
        assert got["stdout"] == ("" if case == "samples_not_vcf"
                                 else "momma\npoppa\nkiddo\n")
    elif case == "unknown_name":
        assert got["exit"].startswith("KeyError")
    else:
        assert got["exit"] == "Error: unexpected number of arguments..."


def test_allele_split_deletions_and_ties(tmp_path, monkeypatch):
    """A 2D at a "--" site counts poppa (two gap characters), a 1D counts
    neither, so a read with only that 1D is a tie and goes nowhere; a read
    over a decoy site alone is a tie too."""
    d = tmp_path / "src"
    d.mkdir()
    g = "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"
    vcf_path = _write(d / "t.vcf", [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tmomma\t"
        "poppa\tkiddo",
        "chr1\t11\t.\tCG\t--\t30\tPASS\t.\tGT\t0/0\t1/1\t0/1",
        "chr1\t21\t.\tA\tC\t30\tPASS\t.\tGT\t0/0\t0/0\t0/1"])
    sam = _write(d / "r.sam", [
        "@SQ\tSN:chr1\tLN:40",
        f"del2\t0\tchr1\t1\t60\t10M2D8M\t*\t0\t0\t{g[:10]}{g[12:20]}\t*",
        f"del1\t0\tchr1\t1\t60\t10M1D9M\t*\t0\t0\t{g[:10]}{g[11:20]}\t*",
        f"decoy\t0\tchr1\t18\t60\t6M\t*\t0\t0\t{g[17:23]}\t*"])
    got = _both(tmp_path, "alleleSplit", lambda _: [
        "-f1", "kiddo", "-parentOne", "momma", "-parentTwo", "poppa", sam,
        vcf_path], chdir=monkeypatch)
    assert got["files"]["kiddo.momma.SNPs.sam"] == b"@SQ\tSN:chr1\tLN:40\n"
    poppa = got["files"]["kiddo.poppa.SNPs.sam"].decode().splitlines()
    assert [ln.split("\t")[0] for ln in poppa[1:]] == ["del2"]


# --- the library: io/vcf's helpers and genotype, against the JAX's


def _headers():
    return [["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
             "FILTER\tINFO\tFORMAT\ta\tb\tc"],
            ["##fileformat=VCFv4.2", '##INFO=<ID=DP,Number=1>',
             '##INFO=<ID=X,Number=1>', '##FORMAT=<ID=GT,Number=1>',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"],
            ["##fileformat=VCFv4.2", '##FORMAT=<ID=GT,Number=1>',
             '##FORMAT=<ID=DP,Number=1>', "#CHROM\tPOS"],
            ["##fileformat=VCFv4.2"], []]


@pytest.mark.parametrize("k", range(5))
def test_header_helpers_equal_jax(k):
    text = _headers()[k]
    outs = []
    for mod in (jvcf, vcf):
        h = mod.Header(text=list(text))
        row = [mod.ancestor_flag_to_header(h).text]
        try:
            row.append(mod.header_get_sample_list(h))
            row.append(mod.header_update_sample_list(h, ["x", "y"]).text)
        except SystemExit as e:
            row.append(str(e))
        row.append(h.text)  # unchanged
        outs.append(row)
    assert outs[0] == outs[1]


def test_sample_tests_and_append_ancestor_equal_jax():
    gts = ["0/0", "0/1", "1|1", "0", "./.", "1/.", "1/2/1", "2|2", "0/0/0"]
    for gt in gts:
        js = jvcf._parse_samples([gt + ":5"], ["GT", "DP"])[0]
        ts = vcf._parse_samples([gt + ":5"], ["GT", "DP"])[0]
        assert (jvcf.is_homozygous(js), jvcf.is_heterozygous(js)) == (
            vcf.is_homozygous(ts), vcf.is_heterozygous(ts))
    assert vcf.is_homozygous(vcf.Sample(alleles=[1, 1]))
    assert not vcf.is_homozygous(vcf.Sample(alleles=[1, 1, 1]))
    for info in (".", "DP=3", "AA=A"):
        j = jvcf.append_ancestor(jvcf.Vcf(info=info), "AC-")
        t = vcf.append_ancestor(vcf.Vcf(info=info), "AC-")
        assert j.info == t.info
    assert vcf.append_ancestor(vcf.Vcf(info="."), "G").info == "AA=G"


def test_annotate_ancestor_equal_jax():
    rng = np.random.default_rng(3005)
    ref, anc = _alignment(rng, 300)
    jrec = [jfasta.Fasta("r", jfasta.dna.from_string(ref)),
            jfasta.Fasta("a", jfasta.dna.from_string(anc))]
    trec = [fasta.Fasta("r", fasta.dna.from_string(ref)),
            fasta.Fasta("a", fasta.dna.from_string(anc))]
    state = {"j": (0, 0), "t": (0, 0)}
    for p in sorted(set(rng.integers(1, 300, 60).tolist())):
        jv, *state["j"] = jvcf.annotate_ancestor_from_multi_fa(
            jvcf.Vcf(pos=p, info="."), jrec, *state["j"])
        tv, *state["t"] = vcf.annotate_ancestor_from_multi_fa(
            vcf.Vcf(pos=p, info="."), trec, *state["t"])
        assert (jv.info, state["j"]) == (tv.info, state["t"])


def _counts(seed: int, n: int = 600) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 25, (n, 4))
    counts[rng.random(n) < 0.3] *= np.array([1, 0, 0, 0])
    counts[::11] = 0
    counts[5::13] = [3, 3, 0, 0]  # ties between genotypes
    refs = rng.integers(0, 10, n)
    return counts, refs


PRIORS = {"diploid": (jgeno.make_diploid_base_prior_cache(0.01, 3.0),
                      geno.make_diploid_base_prior_cache(0.01, 3.0)),
          "flat": (jgeno.make_diploid_base_flat_prior_cache(),
                   geno.make_diploid_base_flat_prior_cache())}
EPS_LAM = [(0.01, 0.0), (0.05, 0.0), (0.01, 0.02), (0.001, 0.3), (0.0, 0.0),
           (0.5, 0.6), (0.2, 0.8)]


@pytest.mark.parametrize("prior", ["diploid", "flat"])
@pytest.mark.parametrize("eps,lam", EPS_LAM)
def test_genotype_batch_equals_jax(prior, eps, lam):
    """The batch caller at device="cpu" against the JAX's, int8 call for
    call, and the log likelihoods by their 64 bits; eps = 0 and eps + lam
    >= 1 give -inf * 0 = NaN posteriors, where torch's argmax takes the
    first NaN as numpy's does."""
    counts, refs = _counts(3006)
    jp, tp = PRIORS[prior]
    assert jp.tobytes() == tp.tobytes()
    with np.errstate(invalid="ignore"):
        want = jgeno.diploid_base_call_batch(counts, refs, jp, eps, lam)
        want_ll = jgeno.base_log_likelihoods(counts, eps, lam)
    got = geno.diploid_base_call_batch(counts, refs, tp, eps, lam,
                                       device="cpu")
    got_ll = geno.base_log_likelihoods(torch.tensor(counts), eps, lam)
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)
    assert got_ll.dtype == torch.float64
    assert got_ll.numpy().tobytes() == want_ll.tobytes()


def test_genotype_batch_wants_the_card(monkeypatch):
    """device=None is the card: without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts, refs = _counts(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        geno.diploid_base_call_batch(counts, refs, PRIORS["flat"][1], 0.01)


def _piles(counts, mod):
    out = []
    for k, row in enumerate(counts):
        f = np.zeros(13, np.int64)
        r = np.zeros(13, np.int64)
        f[:4] = row // 2
        r[:4] = row - row // 2
        f[10] = k % 3  # gaps count nowhere
        out.append(mod.Pile(ref_idx=0, pos=k + 1, count_f=f, count_r=r))
    return out


@pytest.mark.parametrize("eps,lam", EPS_LAM[:4])
def test_genotype_per_pile_equal_jax(eps, lam):
    """diploid_base_call (the hom-ref-seeded scan) and haploid_base_call
    on piles, against the JAX's, under both diploid priors and the
    haploid one."""
    counts, refs = _counts(3007, 300)
    refs = np.where(refs > 4, refs % 5, refs)
    jh = jgeno.make_haploid_base_prior_cache(0.01, 3.0)
    th = geno.make_haploid_base_prior_cache(0.01, 3.0)
    assert jh.tobytes() == th.tobytes()
    for jp, tp in PRIORS.values():
        for jpile, tpile, ref in zip(_piles(counts, jpileup),
                                     _piles(counts, pileup), refs.tolist()):
            assert (jgeno.diploid_base_call(jpile, ref, jp, eps, lam)
                    == geno.diploid_base_call(tpile, ref, tp, eps, lam))
            assert (jgeno.haploid_base_call(jpile, ref, eps, jh, lam)
                    == geno.haploid_base_call(tpile, ref, eps, th, lam))


def test_genotype_tables_equal_jax():
    assert geno.GENOTYPE_STRINGS == jgeno.GENOTYPE_STRINGS
    assert [geno.diploid_base_to_bases(g) for g in range(11)] == [
        jgeno.diploid_base_to_bases(g) for g in range(11)]
    assert [geno.ref_base_to_ref_genotype(b) for b in range(5)] == [
        jgeno.ref_base_to_ref_genotype(b) for b in range(5)]
    for d, gm in ((0.01, 3.0), (0.1, 1.0), (0.3, 0.5)):
        for jf, tf in ((jgeno.make_diploid_base_prior_cache,
                        geno.make_diploid_base_prior_cache),
                       (jgeno.make_haploid_base_prior_cache,
                        geno.make_haploid_base_prior_cache)):
            assert jf(d, gm).tobytes() == tf(d, gm).tobytes()
