"""The port's ``gsw ggtools`` (gonomics_tpu_torch/cli/gsw_cmd.py) and the
host readers under it on the CPU against the JAX package: the output
bytes of every conversion (chain to axt, vcf and gg; vcf to gg; axt to
vcf and gg) on the same files, and the readers and writers alone
(``read_chain``, ``chain_to_axt``, ``read_axt``, ``axt_to_vcf``, the VCF
read and write, ``fasta.write``, ``dna.to_lower``). The inputs come from
a numpy seed (tests/test_torch_card.py ``_tools_inputs``: two
chromosomes of a few kbp, SNPs, 1-10 bp indels, an N run, a lower-case
stretch, one chain on the query's - strand).
"""

import dataclasses
import os

import numpy as np
import pytest

from gonomics_tpu import dna as jdna
from gonomics_tpu.cli import gsw_cmd as jgsw
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import formats as jformats
from gonomics_tpu.io import vcf as jvcf
from gonomics_tpu_torch import dna
from gonomics_tpu_torch.cli import gsw_cmd as tgsw
from gonomics_tpu_torch.io import fasta, formats, vcf

from test_torch_card import _tools_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gg"))
    t, q, chain, snps, _ = _tools_inputs(tmp, seed=3)
    files = {"tmp": tmp, "t": t, "q": q, "chain": chain, "snps": snps}
    # the JAX tool's own axt and vcf of the chain: the inputs of the
    # vcf and axt conversions
    for fmt in ("axt", "vcf"):
        files[fmt] = os.path.join(tmp, "chain." + fmt)
        jgsw.main(["ggtools", chain, "-t", t, "-q", q, "-f", fmt, "-o",
                   files[fmt]])
    files["hand_axt"] = os.path.join(tmp, "hand.axt")
    with open(files["hand_axt"], "w") as f:
        f.write(_HAND_AXT)
    return files


# a SNP, an insertion, a deletion, an N against a base, lower case, and
# a - strand block; blocks numbered as the reference numbers them
_HAND_AXT = ("# made by hand\n"
             "0 chrA 1 20 chrQ 1 22 + 100\n"
             "ACGTAC--GTACGtacgTACGA\n"
             "ACGAACTTGTACGtacgTACGA\n\n"
             "1 chrA 31 45 chrQ 5 15 - 80\n"
             "ACGNTTGCAAGGCTA\n"
             "ACGATTG----GCTA\n\n"
             "2 chrB 3 12 chrR 3 12 + 7\n"
             "GGGGCCCCAA\n"
             "GGTGCCACAA\n\n")


def _run(main, args, out):
    main(["ggtools", *args, "-o", out])
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("src,fmt", [("chain", "axt"), ("chain", "vcf"),
                                     ("chain", "gg"), ("vcf", "gg"),
                                     ("axt", "vcf"), ("axt", "gg"),
                                     ("hand_axt", "vcf"),
                                     ("hand_axt", "gg")])
def test_ggtools_byte_identical(inputs, src, fmt):
    """Each conversion's output bytes equal the JAX tool's."""
    args = [inputs[src], "-t", inputs["t"]]
    if src == "chain":
        args += ["-q", inputs["q"]]
    if src != "vcf":
        args += ["-f", fmt]
    if src == "hand_axt" and fmt == "gg":
        # the hand blocks name chrA and chrB: a target of those names
        hand_fa = os.path.join(inputs["tmp"], "hand.fa")
        rng = np.random.default_rng(1)
        jfasta.write(hand_fa, [jfasta.Fasta(n, rng.integers(0, 4, 60)
                                            .astype(np.int8))
                               for n in ("chrA", "chrB")])
        args[2] = hand_fa
    base = os.path.join(inputs["tmp"], f"{src}_to")
    want = _run(jgsw.main, args, base + "_jax." + fmt)
    got = _run(tgsw.main, args, base + "_port." + fmt)
    assert got == want
    assert len(got) > 100


def test_chain_vcf_holds_every_planted_snp(inputs):
    """Every planted SNP is a record of the chain's VCF, at its position
    with its ref and alt; the N against a base is not."""
    records, header = vcf.read(inputs["vcf"])
    assert header.text == vcf.new_header().text
    got = {(v.chrom, v.pos, v.ref, v.alt[0]) for v in records}
    want = {(c, *s) for c, snps in inputs["snps"].items() for s in snps}
    assert want and want <= got
    assert not any("N" in v.ref or "N" in v.alt[0] for v in records)


@pytest.mark.parametrize("args,match", [
    (["chain", "-t", "t"], "Must specify both target and query"),
    (["vcf"], "Must specify target reference"),
    (["chain", "-t", "t", "-q", "q", "-f", "bed"], "unsupported chain"),
    (["axt", "-f", "sam"], "unsupported axt"),
    (["t"], "unrecognized input file type")])
def test_ggtools_refusals_match(inputs, tmp_path, args, match):
    """Missing FASTA files, unknown formats and unknown inputs exit with
    the JAX tool's message."""
    args = [inputs.get(a, a) for a in args]
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit, match=match) as want:
        jgsw.main(["ggtools", *args, "-o", out])
    with pytest.raises(SystemExit) as got:
        tgsw.main(["ggtools", *args, "-o", out])
    assert str(got.value) == str(want.value)


def _fields(obj):
    d = dataclasses.asdict(obj)
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def test_read_chain_and_chain_to_axt(inputs):
    """Chains, comments and blocks as the JAX reads them; each chain's axt
    block equal field for field and as text."""
    got, got_comments = formats.read_chain(inputs["chain"])
    want, want_comments = jformats.read_chain(inputs["chain"])
    assert got_comments == want_comments == ["#a chain file"]
    assert [_fields(c) for c in got] == [_fields(c) for c in want]
    tmap = {r.name: r.seq for r in fasta.read(inputs["t"])}
    qmap = {r.name: r.seq for r in fasta.read(inputs["q"])}
    for g, w in zip(got, want):
        ga = formats.chain_to_axt(g, tmap[g.t_name], qmap[g.q_name])
        wa = jformats.chain_to_axt(w, tmap[w.t_name], qmap[w.q_name])
        assert _fields(ga) == _fields(wa)
        assert formats.axt_to_string(ga, 3) == jformats.axt_to_string(wa, 3)
    assert [c.q_strand for c in got] == [True, False]


@pytest.mark.parametrize("src", ["axt", "hand_axt"])
def test_read_axt_and_axt_to_vcf(inputs, src):
    """Blocks as the JAX reads them; each block's records, duplicate
    insertions included, as the JAX's axt_to_vcf gives them."""
    got = formats.read_axt(inputs[src])
    want = jformats.read_axt(inputs[src])
    assert [_fields(a) for a in got] == [_fields(a) for a in want]
    n = 0
    for g, w in zip(got, want):
        gv = [v.to_string() for v in formats.axt_to_vcf(g)]
        assert gv == [v.to_string() for v in jformats.axt_to_vcf(w)]
        n += len(gv)
    assert n > 0


@pytest.mark.parametrize("gap", ["target", "query"])
def test_axt_starting_with_a_gap_refused(gap):
    """A block that opens with a gap raises the JAX's IndexError."""
    r, q = ("-AC", "GAC") if gap == "target" else ("GAC", "-AC")
    kw = dict(r_name="c", r_start=1, r_end=3, q_name="q", q_start=1,
              q_end=3)
    with pytest.raises(IndexError) as want:
        jformats.axt_to_vcf(jformats.Axt(r_seq=jdna.from_string(r),
                                         q_seq=jdna.from_string(q), **kw))
    with pytest.raises(IndexError) as got:
        formats.axt_to_vcf(formats.Axt(r_seq=dna.from_string(r),
                                       q_seq=dna.from_string(q), **kw))
    assert str(got.value) == str(want.value)


_VCF_TEXT = (
    "##fileformat=VCFv4.2\n"
    "##INFO=<ID=DP,Number=1,Type=Integer,Description=\"depth\">\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\n"
    "chr1\t10\trs1\tA\tG\t30\tPASS\tDP=4\tGT:DP\t0|1:4\t1/1:7\n"
    "chr1\t12\t.\tAC\tA,ACT\t.\t.\t.\tGT\t./.\t1|.\n"
    "\n"
    "chr2\t3\t.\tT\tC\t13.5\tq10\tSVTYPE=SNP\tDP:GT\t4:0/1\t.:.\n"
    "chr2\t9\t.\tG\t\t0\tPASS\t.\t.\t0/1\t1/1\n"
    "chr2\t20\t.\tG\tT\t7\tPASS\tSVTYPE=SNP\n")


def test_vcf_read_write_round_trip(tmp_path):
    """Records and header as the JAX reads them, written back to the
    JAX's bytes: genotypes phased and not, missing alleles, a format
    without GT, '.' format, '.' quality, no alt, no samples."""
    path = tmp_path / "in.vcf"
    path.write_text(_VCF_TEXT)
    got, got_header = vcf.read(str(path))
    want, want_header = jvcf.read(str(path))
    assert got_header.text == want_header.text
    assert [_fields(v) for v in got] == [_fields(v) for v in want]
    out = {}
    for name, mod, records, header in (("port", vcf, got, got_header),
                                       ("jax", jvcf, want, want_header)):
        p = tmp_path / f"{name}.vcf"
        with open(p, "w") as f:
            mod.new_write_header(f, header)
            for v in records:
                mod.write_vcf(f, v)
        out[name] = p.read_bytes()
    assert out["port"] == out["jax"]
    assert vcf.new_header().text == jvcf.new_header().text
    for name in ("a.vcf", "a.vcf.gz", "a.vcf.txt", "a.chain", "a.axt.gz"):
        assert vcf.is_vcf_file(name) == jvcf.is_vcf_file(name)
        assert formats.is_chain_file(name) == jformats.is_chain_file(name)
        assert formats.is_axt_file(name) == jformats.is_axt_file(name)


@pytest.mark.parametrize("line_length", [50, 60, 7])
def test_fasta_write(tmp_path, line_length):
    """Records of 0, 1 and a few hundred bases, all 13 codes, in the
    JAX's bytes."""
    rng = np.random.default_rng(line_length)
    seqs = [np.zeros(0, np.int8), np.array([dna.N], np.int8),
            rng.integers(0, dna.NUM_BASES, 333).astype(np.int8)]
    names = ["empty", "one", "all codes"]
    got, want = tmp_path / "port.fa", tmp_path / "jax.fa"
    fasta.write(str(got), [fasta.Fasta(n, s) for n, s in zip(names, seqs)],
                line_length)
    jfasta.write(str(want), [jfasta.Fasta(n, s) for n, s in zip(names, seqs)],
                 line_length)
    assert got.read_bytes() == want.read_bytes()


def test_to_lower_and_all_gaps():
    codes = np.arange(dna.NUM_BASES, dtype=np.int8)
    assert np.array_equal(dna.to_lower(codes), jdna.to_lower(codes))
    assert dna.to_lower(codes).dtype == np.int8
    for n in (0, 1, 9):
        assert np.array_equal(dna.all_gaps(n), jdna.all_gaps(n))
