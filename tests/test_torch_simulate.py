"""The port's read simulator and simulation tools
(gonomics_tpu_torch/simulate.py, cli/simulate_sam.py,
cli/simulate_tools.py) on the CPU against the JAX package: the bytes of
every file each tool writes (SAM, BAM, deamination table, bed, VCF,
FASTQ), stdout and the message of every exit, on references and beds
built here from a numpy seed; each library function that takes a Go
generator, its value and the generator's ``_v``, ``tap`` and ``feed``
after the call; and one case for each of the reference's quirks.

simulateVcf and simulateDivergentWindowsVcf spend ~17 ms a site in
``bounded_rejection_sample``, so their cases keep to at most 20 sites.
"""

import numpy as np
import pytest

from gonomics_tpu import simulate as jsim
from gonomics_tpu.cli import simulate_sam as jsam_cli
from gonomics_tpu.cli import simulate_tools as jtools
from gonomics_tpu.io import bed as jbed
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import sam as jsamio
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu.numbers import gosamplers as jgs
from gonomics_tpu_torch import dna
from gonomics_tpu_torch import simulate as tsim
from gonomics_tpu_torch.cli import simulate_sam as tsam_cli
from gonomics_tpu_torch.cli import simulate_tools as ttools
from gonomics_tpu_torch.io import bed as tbed
from gonomics_tpu_torch.io import fasta as tfasta
from gonomics_tpu_torch.io import sam as tsamio
from gonomics_tpu_torch.numbers import gorand as tgr
from gonomics_tpu_torch.numbers import gosamplers as tgs


def _state(rng):
    return rng._v, rng.tap, rng.feed


def _rngs(seed):
    return jgr.GoRand(seed), tgr.GoRand(seed)


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _write_fa(path, seqs):
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name}\n{s}\n")
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """ref.fa: two chroms of mixed case, no N; tn.fa: the same with N
    runs; ng.bed: tn.fa's ungapped runs, named; ng3.bed: the same with
    3 fields; short.bed: regions some shorter than 300."""
    d = tmp_path_factory.mktemp("simulate")
    rng = np.random.default_rng(3200)
    chr1 = rng.choice(list("ACGTacgt"), 4000)
    chr2 = rng.choice(list("ACGT"), 1500)
    ref = {"chr1": "".join(chr1), "chr2": "".join(chr2)}
    gaps = {"chr1": [(300, 350), (2100, 2400)], "chr2": [(700, 760)]}
    tn, ng = {}, []
    for name, seq in ref.items():
        s = np.array(list(seq))
        prev = 0
        for a, b in gaps[name]:
            s[a:b] = "N"
            ng.append((name, prev, a))
            prev = b
        ng.append((name, prev, len(s)))
        tn[name] = "".join(s)
    files = {"ref.fa": _write_fa(d / "ref.fa", ref),
             "tn.fa": _write_fa(d / "tn.fa", tn)}
    for name, rows in (
            ("ng.bed", [f"{c}\t{s}\t{e}\t{c}_{s}" for c, s, e in ng]),
            ("ng3.bed", [f"{c}\t{s}\t{e}" for c, s, e in ng]),
            ("short.bed", ["chr1\t0\t120", "chr1\t500\t900\tlong",
                           "chr2\t10\t200", "chr2\t300\t1000"]),
            ("matched.bed", ["chr1\t0\t100", "chr1\t5\t106", "chr2\t3\t104",
                             "chr2\t0\t100"])):
        (d / name).write_text("".join(r + "\n" for r in rows))
        files[name] = str(d / name)
    files["seqs"] = ref
    files["dir"] = d
    return files


def _outcome(main, argv, outs):
    """The bytes of each file in outs after main(argv), or the type and
    message of what it raised."""
    try:
        main(list(argv))
    except BaseException as e:  # SystemExit included
        return "raise", type(e).__name__, str(e)
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(f.read())
    return "ok", res


def _both(tmp_path, capsys, jmain, tmain, argv_of, names):
    """The JAX and port outcomes and stdout; argv_of(paths) builds the
    argv from the output paths of one side."""
    res = []
    for side, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        outs = [str(d / n) for n in names]
        res.append((_outcome(main, argv_of(outs), outs),
                    capsys.readouterr().out))
    return res


# --- simulateSam ---

SAM_CASES = {
    "n": ["-n", "60"],
    "seed": ["-n", "40", "-setSeed", "7"],
    "coverage": ["-coverage", "0.5"],
    "read_length": ["-n", "30", "-readLength", "75", "-fragmentLength",
                    "151", "-fragmentStdDev", "10"],
    "flat_error": ["-n", "40", "-flatErrorRate", "0.05"],
    "ancient": ["-n", "40", "-ancientErrorRate", "0.1",
                "-geometricParam", "0.3", "-deaminationDistribution", "D"],
    "both_errors": ["-n", "30", "-flatErrorRate", "0.02",
                    "-ancientErrorRate", "0.05",
                    "-deaminationDistribution", "D"],
    "zero_std": ["-n", "20", "-fragmentLength", "201", "-fragmentStdDev",
                 "0"],
    "no_reads": [],
    "negative_coverage": ["-coverage", "-1"],
    "both": ["-n", "5", "-coverage", "1"],
    "zero_n_negative_coverage": ["-n", "0", "-coverage", "-2"],
    "n_negative_coverage": ["-n", "3", "-coverage", "-1"],
    "short_fragment": ["-n", "5", "-fragmentLength", "100"],
}
SAM_EXITS = {  # checked in this order: coverage, count, both
    "negative_coverage": "Error: coverage must be a value greater than 0.",
    "zero_n_negative_coverage":
        "Error: coverage must be a value greater than 0.",
    "n_negative_coverage": "Error: coverage must be a value greater than 0.",
    "no_reads": "Error: number of reads must be greater than 0.",
    "both": "Error: specify either -coverage or -n, not both.",
}


@pytest.mark.parametrize("ext", ["sam", "bam"])
@pytest.mark.parametrize("case", sorted(SAM_CASES))
def test_simulate_sam_equals_jax(inputs, tmp_path, capsys, case, ext):
    """simulateSam's SAM or BAM bytes and deamination table, or its exit
    message, equal the JAX tool's; the exits are checked in the JAX's
    order."""
    args = SAM_CASES[case]
    names = ["out." + ext] + (["d.txt"] if "D" in args else [])

    def argv_of(outs):
        a = [outs[1] if x == "D" else x for x in args]
        return [inputs["ref.fa"], outs[0], *a]

    jax, port = _both(tmp_path, capsys, jsam_cli.main, tsam_cli.main,
                      argv_of, names)
    assert port == jax
    if case in SAM_EXITS:
        assert jax[0] == ("raise", "SystemExit", SAM_EXITS[case])
    elif jax[0][0] == "ok":
        assert jax[0][1][0]


def test_simulate_sam_library_equals_jax(inputs, tmp_path):
    """simulate_sam through the library, keyword for keyword."""
    kw = dict(num_reads=25, flat_error_rate=0.03, ancient_error_rate=0.04,
              geometric_param=0.2, set_seed=11, fragment_length=300,
              fragment_std=40.0)
    out = {}
    for side, mod in (("jax", jsim), ("port", tsim)):
        o = str(tmp_path / f"{side}.sam")
        d = str(tmp_path / f"{side}.d")
        mod.simulate_sam(inputs["ref.fa"], o, deamination_distribution=d,
                         **kw)
        out[side] = (open(o).read(), open(d).read())
    assert out["port"] == out["jax"]
    assert tsim.GC == jsim.GC == 0.42


def test_change_base_state(inputs):
    for seed in (1, 5, 99):
        j, t = _rngs(seed)
        jv = [jsim._go_change_base(j, b) for b in (0, 1, 2, 3, 0, 2) * 5]
        tv = [tsim._go_change_base(t, b) for b in (0, 1, 2, 3, 0, 2) * 5]
        assert tv == jv
        assert all(v != b for v, b in zip(tv, (0, 1, 2, 3, 0, 2) * 5))
        assert _state(t) == _state(j)
        jv = [jtools._change_base(j, b) for b in (3, 1) * 4]
        tv = [ttools._change_base(t, b) for b in (3, 1) * 4]
        assert tv == jv and _state(t) == _state(j)


@pytest.mark.parametrize("rate", [0.01, 0.2, 0.9])
def test_sequencing_error_state(rate):
    seq0 = np.random.default_rng(1).integers(0, 4, 150).astype(np.int8)
    j, t = _rngs(17)
    ja, ta = jgs.make_binomial_alias(150, rate), tgs.make_binomial_alias(
        150, rate)
    for _ in range(5):
        js, ts = seq0.copy(), seq0.copy()
        jsim._sequencing_error_go(j, js, ja)
        tsim._sequencing_error_go(t, ts, ta)
        assert np.array_equal(ts, js)
        assert _state(t) == _state(j)


@pytest.mark.parametrize("rate,geo", [(0.05, 0.25), (0.5, 0.1)])
def test_ancient_damage_state(rate, geo):
    """C->T and G->A only; A and T use up their slot; the shared
    deamination counts equal the JAX's; an N raises as in the JAX."""
    frag0 = np.random.default_rng(2).integers(0, 4, 300).astype(np.int8)
    j, t = _rngs(23)
    ja, ta = jgs.make_binomial_alias(150, rate), tgs.make_binomial_alias(
        150, rate)
    jd, td = [0] * 150, [0] * 150
    for _ in range(6):
        jf, tf = frag0.copy(), frag0.copy()
        jsim._ancient_damage_go(j, jf, ja, geo, jd)
        tsim._ancient_damage_go(t, tf, ta, geo, td)
        assert np.array_equal(tf, jf) and td == jd
        assert _state(t) == _state(j)
        changed = tf != frag0
        assert set(zip(frag0[changed], tf[changed])) <= {(dna.C, dna.T),
                                                         (dna.G, dna.A)}
    assert sum(td) > 0
    frag = np.full(20, dna.N, np.int8)
    for mod, rng, alias in ((jsim, j, ja), (tsim, t, ta)):
        with pytest.raises(ValueError, match="unrecognized base: 4"):
            mod._ancient_damage_go(rng, frag.copy(), alias, geo, [0] * 150)


def test_generate_read_and_flags_state():
    frag = np.random.default_rng(3).integers(0, 4, 380).astype(np.int8)
    j, t = _rngs(31)
    ja, ta = jgs.make_binomial_alias(150, 0.02), tgs.make_binomial_alias(
        150, 0.02)
    seen = set()
    for i in range(12):
        jr = jsim._generate_sam_read_no_flag(j, f"r{i}", "chrZ", frag, 150,
                                             1000 + i, 0.02, ja)
        tr = tsim._generate_sam_read_no_flag(t, f"r{i}", "chrZ", frag, 150,
                                             1000 + i, 0.02, ta)
        assert [r.to_string() for r in tr] == [r.to_string() for r in jr]
        assert _state(t) == _state(j)
        jr = jsim._add_paired_flags_go(j, *jr)
        tr = tsim._add_paired_flags_go(t, *tr)
        assert [r.to_string() for r in tr] == [r.to_string() for r in jr]
        assert _state(t) == _state(j)
        seen.add((tr[0].flag, tr[1].flag))
        assert all(33 + 30 <= ord(c) < 33 + 40 for r in tr for c in r.qual)
        assert all(30 <= r.mapq < 40 and r.tlen == 150 for r in tr)
    assert seen == {(99, 147), (83, 163)}


@pytest.mark.parametrize("flags", [(0, 0), (1, 0), (0, 1)])
def test_add_paired_flags_unmapped(flags):
    """The branches for records without a CIGAR."""
    for seed in range(1, 7):
        out = []
        for mod, samio, rng in zip((jsim, tsim), (jsamio, tsamio),
                                   _rngs(seed)):
            f, r = samio.Sam(qname="f"), samio.Sam(qname="r")
            if flags[0]:
                f.cigar = [samio.samcigar.CigarOp(10, "M")]
            if flags[1]:
                r.cigar = [samio.samcigar.CigarOp(10, "M")]
            a, b = mod._add_paired_flags_go(rng, f, r)
            out.append((a.qname, a.flag, b.qname, b.flag, _state(rng)))
        assert out[1] == out[0]


def test_reads_per_contig_state(inputs):
    jrec = jfasta.read(inputs["ref.fa"])
    trec = tfasta.read(inputs["ref.fa"])
    for n, cov in ((100, 0.0), (7, 0.0), (0, 3.0), (5, 0.25)):
        j, t = _rngs(n + 1)
        jc = jsim._get_reads_per_contig_go(j, jrec, n, cov, 150)
        tc = tsim._get_reads_per_contig_go(t, trec, n, cov, 150)
        assert tc == jc and _state(t) == _state(j)
        if cov:
            assert sum(tc) == int(cov * 5500 / 300)


def _fragment_model(records, ref, read_len, avg, std):
    """The reads of one contig that the fragment buffer's reuse gives,
    replayed from the records' positions: (fwd, rev) per pair, each as
    a string."""
    cap_ = avg + int(5 * std)
    buf = np.zeros(cap_, np.int8)
    length = 0
    n = len(ref)
    out = []
    for k in range(0, len(records), 2):
        a, b = sorted(records[k:k + 2], key=lambda r: r.pos)
        start = a.pos - 1
        size = b.pos - a.pos + read_len
        assert start > 0  # a clamped start hides the midpoint
        end = min(start + 2 * (size // 2), n)
        if length + size > cap_:
            cap_ = length + size
            buf = np.zeros(cap_, np.int8)
        length = size
        m = min(size, end - start)
        buf[:m] = ref[start:start + m]
        frag = buf[:size]
        out.append((dna.to_string(frag[:read_len]),
                    dna.to_string(frag[size - read_len:])))
    return out


def test_fragment_buffer_carries_over():
    """The buffer is reused without clearing: where a fragment's size is
    odd, or it meets the contig's end, its tail holds the previous
    fragment's bases (0 = A in a new buffer). SEQ is never
    reverse-complemented; TLEN is the read length; RNEXT is '=' and
    PNEXT the mate's POS; names run <contig>_Read:<i>."""
    ref = np.random.default_rng(5).integers(0, 4, 20000).astype(np.int8)
    res = {}
    for side, mod, gs, rng in (("jax", jsim, jgs, jgr.GoRand(8)),
                               ("port", tsim, tgs, tgr.GoRand(8))):
        alias = gs.make_binomial_alias(150, 0.0)
        recs = mod.illumina_paired_sam_go(rng, "chrQ", ref, 60, 150, 300,
                                          60.0, 0.0, 0.0, alias, alias, 0.25,
                                          [0] * 150)
        res[side] = ([r.to_string() for r in recs], _state(rng))
    assert res["port"] == res["jax"]
    recs = [tsamio.Sam(qname=ln.split("\t")[0], flag=int(ln.split("\t")[1]),
                       pos=int(ln.split("\t")[3]),
                       seq=dna.from_string(ln.split("\t")[9]))
            for ln in res["port"][0]]
    model = _fragment_model(recs, ref, 150, 300, 60.0)
    got = [tuple(dna.to_string(r.seq) for r in sorted(recs[k:k + 2],
                                                      key=lambda r: r.pos))
           for k in range(0, len(recs), 2)]
    assert got == model
    plain = [(dna.to_string(ref[a.pos - 1:a.pos + 149]),
              dna.to_string(ref[b.pos - 1:b.pos + 149]))
             for a, b in (sorted(recs[k:k + 2], key=lambda r: r.pos)
                          for k in range(0, len(recs), 2))]
    carried = [k for k, (g, p) in enumerate(zip(got, plain)) if g != p]
    assert carried  # odd sizes leave a base of the previous fragment
    assert any(got[k][1][-1] != "A" for k in carried)
    assert any(r.flag & 16 for r in recs)
    assert max(r.pos for r in recs) + 149 > len(ref)  # meets the end
    for k, ln in enumerate(res["port"][0]):
        f = ln.split("\t")
        mate = res["port"][0][k ^ 1].split("\t")
        assert f[0] == f"chrQ_Read:{k // 2}"
        assert (f[5], f[6], f[7], f[8]) == ("150M", "=", mate[3], "150")


def test_zero_std_odd_fragment_ends_in_a(inputs, tmp_path):
    """With -fragmentStdDev 0 every fragment is 201 long, one more than
    the copy fills: the far read's last base is the new buffer's 0, A,
    whatever the reference holds there."""
    out = str(tmp_path / "o.sam")
    tsam_cli.main([inputs["ref.fa"], out, "-n", "40", "-fragmentLength",
                   "201", "-fragmentStdDev", "0"])
    recs = [ln.split("\t") for ln in _lines(out) if not ln.startswith("@")]
    seqs = {k: v.upper() for k, v in inputs["seqs"].items()}
    far = 0
    for k in range(0, len(recs), 2):
        a, b = sorted(recs[k:k + 2], key=lambda f: int(f[3]))
        assert int(b[3]) - int(a[3]) == 51
        assert b[9][-1] == "A"
        if int(b[3]) + 149 <= len(seqs[b[2]]):
            far += seqs[b[2]][int(b[3]) + 148] != "A"
    assert far > 5


def test_simulate_sam_reads_match_upper_reference(inputs, tmp_path):
    """The reference is upper-cased; names restart on each contig; the
    deamination table has one row a read position."""
    out, d = str(tmp_path / "o.sam"), str(tmp_path / "d.txt")
    tsam_cli.main([inputs["ref.fa"], out, "-n", "80", "-ancientErrorRate",
                   "0.05", "-deaminationDistribution", d])
    lines = _lines(out)
    assert lines[:3] == ["@HD\tVN:1.6\tSO:unsorted", "@SQ\tSN:chr1\tLN:4000",
                         "@SQ\tSN:chr2\tLN:1500"]
    recs = [ln.split("\t") for ln in lines[3:]]
    assert len(recs) == 160
    assert all(set(f[9]) <= set("ACGT") for f in recs)
    for chrom in ("chr1", "chr2"):
        idx = [int(f[0].split(":")[1]) for f in recs if f[2] == chrom]
        assert idx == sorted(idx) and idx[0] == 0
    tab = _lines(d)
    assert tab[0] == "Position\tCount" and len(tab) == 151
    assert [int(r.split("\t")[0]) for r in tab[1:]] == list(range(150))


# --- simulateBed ---

BED_CASES = {
    "plain": ("ng.bed", ["-N", "40", "-L", "200", "-setSeed", "10"]),
    "unnamed": ("ng3.bed", ["-N", "25", "-L", "100", "-setSeed", "4"]),
    "short_skipped": ("short.bed", ["-N", "30", "-L", "300", "-setSeed",
                                    "2"]),
    "matched": ("ng.bed", ["-matchedBed", "matched.bed", "-setSeed", "6"]),
    "default_seed": ("ng.bed", ["-N", "5"]),
    "too_long": ("short.bed", ["-N", "5", "-L", "5000", "-setSeed", "1"]),
}


@pytest.mark.parametrize("case", sorted(BED_CASES))
def test_simulate_bed_equals_jax(inputs, tmp_path, capsys, case):
    src, args = BED_CASES[case]
    args = [inputs.get(a, a) for a in args]
    jax, port = _both(tmp_path, capsys, jtools.main_bed, ttools.main_bed,
                      lambda o: [inputs[src], o[0], *args], ["out.bed"])
    assert port == jax


def test_simulate_bed_quirks(inputs, tmp_path):
    """A region shorter than -L is skipped; 4 fields only where the
    region has a name; -matchedBed takes the count and the mean length
    rounded half up (100.25 -> 100, then 100.5 -> 101)."""
    out = str(tmp_path / "o.bed")
    ttools.main_bed([inputs["short.bed"], out, "-N", "50", "-L", "300",
                     "-setSeed", "2"])
    rows = [ln.split("\t") for ln in _lines(out)]
    assert len(rows) == 50
    for r in rows:
        s, e = int(r[1]), int(r[2])
        assert e - s == 300
        if r[0] == "chr1":
            assert 500 <= s and e <= 900 and r[3:] == ["long"]
        else:
            assert 300 <= s and e <= 1000 and len(r) == 3
    m = tmp_path / "m.bed"
    for rows_in, want in ((["chr1\t0\t100"] * 3 + ["chr1\t0\t101"], 100),
                          (["chr1\t0\t100", "chr1\t0\t101"], 101)):
        m.write_text("".join(r + "\n" for r in rows_in))
        ttools.main_bed([inputs["ng.bed"], out, "-matchedBed", str(m),
                         "-setSeed", "3"])
        got = [ln.split("\t") for ln in _lines(out)]
        assert len(got) == len(rows_in)
        assert {int(g[2]) - int(g[1]) for g in got} == {want}


def test_bed_library_equals_jax(inputs):
    jr, tr = jbed.read(inputs["ng.bed"]), tbed.read(inputs["ng.bed"])
    for length in (1, 50, 700, 2000, 5000):
        assert ttools.count_windows(tr, length) == jtools.count_windows(
            jr, length)
        total = ttools.count_windows(tr, length)
        for pos in sorted({0, 1, total // 3, total - 1, total, total + 5}):
            jb, jf = jtools.generate_bed_region(jr, pos, length)
            tb, tf = ttools.generate_bed_region(tr, pos, length)
            assert (tf, vars(tb)) == (jf, vars(jb))
    jrec, trec = jfasta.read(inputs["tn.fa"]), tfasta.read(inputs["tn.fa"])
    assert ([vars(b) for b in ttools._ungapped_regions_all(trec)]
            == [vars(b) for b in jtools._ungapped_regions_all(jrec)])


# --- simulateVcf and the divergent windows ---

VCF_CASES = {
    "plain": ["-numSites", "8", "-alpha", "4", "-numAlleles", "20",
              "-setSeed", "11"],
    "odd_alleles": ["-numSites", "5", "-numAlleles", "7", "-setSeed", "2"],
    "negative_alpha": ["-numSites", "4", "-alpha", "-3", "-setSeed", "5"],
    "bounds": ["-numSites", "4", "-boundAlpha", "0.5", "-boundBeta", "0.5",
               "-boundMultiplier", "5000", "-alpha", "1", "-setSeed", "9"],
    "bad_bound": ["-numSites", "4", "-boundAlpha", "0.5", "-boundBeta",
                  "0.5", "-boundMultiplier", "50", "-alpha", "1",
                  "-setSeed", "9"],
    "ref": ["-refFile", "tn.fa", "-numSites", "10", "-setSeed", "11"],
    "ref_seed": ["-refFile", "ref.fa", "-numSites", "6", "-setSeed", "3",
                 "-numAlleles", "5"],
}


@pytest.mark.parametrize("case", sorted(VCF_CASES))
def test_simulate_vcf_equals_jax(inputs, tmp_path, capsys, case):
    args = [inputs.get(a, a) for a in VCF_CASES[case]]
    jax, port = _both(tmp_path, capsys, jtools.main_vcf, ttools.main_vcf,
                      lambda o: [o[0], *args], ["out.vcf"])
    assert port == jax
    if case == "bad_bound":
        assert jax[0] == ("raise", "RuntimeError", "BoundedRejectionSample: "
                          "invalid bounding function")
    else:
        assert jax[0][0] == "ok" and jax[0][1][0]


def test_simulate_vcf_without_ref(tmp_path):
    """chr1 at 1..n, A/T, QUAL 100, the ancestor appended (ALT where
    divergent); with an odd allele count the last sample is haploid."""
    out = str(tmp_path / "o.vcf")
    ttools.main_vcf([out, "-numSites", "6", "-numAlleles", "7", "-alpha",
                     "2", "-setSeed", "13"])
    for k, ln in enumerate(_lines(out)):
        f = ln.split("\t")
        assert f[:8] == ["chr1", str(k + 1), ".", "A", "T", "100", ".",
                         f[7]]
        assert f[7] in ("AA=A", "AA=T") and f[8] == "GT"
        assert len(f) == 9 + 4 and f[-1] in ("0/-1", "1/-1")
        alts = sum(int(a) for s in f[9:] for a in s.split("/") if a != "-1")
        assert 1 <= alts <= 6


def test_simulate_vcf_ref_dedup_crosses_chroms(tmp_path):
    """The dedup key is the chrom-local start alone: a start drawn on
    one chrom blocks it on the other, so 10 sites over chroms of 10 and
    3 bases take the 10 starts once each. ALT differs from REF."""
    fa = _write_fa(tmp_path / "r.fa", {"chrA": "ACGTACGTAC", "chrB": "GGT"})
    out = {}
    for side, main in (("jax", jtools.main_vcf), ("port", ttools.main_vcf)):
        o = str(tmp_path / f"{side}.vcf")
        main([o, "-refFile", fa, "-numSites", "10", "-setSeed", "7",
              "-numAlleles", "4"])
        out[side] = _lines(o)
    assert out["port"] == out["jax"]
    rows = [ln.split("\t") for ln in out["port"]]
    assert sorted(int(r[1]) for r in rows) == list(range(1, 11))
    assert {r[0] for r in rows} == {"chrA", "chrB"}
    seqs = {"chrA": "ACGTACGTAC", "chrB": "GGT"}
    for r in rows:
        assert r[3] == seqs[r[0]][int(r[1]) - 1] and r[4] != r[3]


def test_simulate_vcf_ref_underscore_chrom_fails(tmp_path):
    """The chrom is the region name cut at its first '_', so a chrom
    whose name holds '_' is looked up under its prefix and fails."""
    fa = _write_fa(tmp_path / "r.fa", {"chr_1": "ACGTACGT"})
    res = []
    for main in (jtools.main_vcf, ttools.main_vcf):
        try:
            main([str(tmp_path / "o.vcf"), "-refFile", fa, "-numSites", "2",
                  "-setSeed", "1"])
            res.append("ok")
        except KeyError as e:
            res.append(("KeyError", str(e)))
    assert res[0] == res[1] == ("KeyError", "'chr'")


def test_seg_site_library_state():
    """simulate_seg_site, simulate_genotype and single_vcf_random: value
    and generator state; the alleles are shuffled with rng.shuffle."""
    for seed, alpha, n in ((3, 0.01, 10), (4, 4.0, 9), (5, -2.0, 6)):
        j, t = _rngs(seed)
        assert (ttools.simulate_seg_site(t, alpha, n, 0.001, 0.001, 1e4)
                == jtools.simulate_seg_site(j, alpha, n, 0.001, 0.001, 1e4))
        assert _state(t) == _state(j)
        js, jd = jtools.simulate_genotype(j, alpha, n, 0.001, 0.001, 1e4)
        ts, td = ttools.simulate_genotype(t, alpha, n, 0.001, 0.001, 1e4)
        assert td == jd and [vars(s) for s in ts] == [vars(s) for s in js]
        assert _state(t) == _state(j)
        jv = jtools.single_vcf_random(j, alpha, n, 0.001, 0.001, 1e4, 42)
        tv = ttools.single_vcf_random(t, alpha, n, 0.001, 0.001, 1e4, 42)
        assert repr(tv) == repr(jv)
        assert _state(t) == _state(j)


def test_seg_site_exits_after_a_million_tries(monkeypatch):
    """Where no draw segregates, the JAX's message after 1,000,000
    tries (a bounded sampler that returns 0 makes every count 0)."""
    calls = {"n": 0}

    def zero(rng, bound, f, a, b, m):
        calls["n"] += 1
        return 0.0, 0

    monkeypatch.setattr(ttools, "bounded_rejection_sample", zero)
    monkeypatch.setattr(ttools, "scaled_beta_sampler",
                        lambda rng, a, b, m: None)
    with pytest.raises(SystemExit,
                       match="unable to produce non-zero allele frequency"):
        ttools.simulate_seg_site(tgr.GoRand(1), 1.0, 1, 0.001, 0.001, 1e4)
    assert calls["n"] == 1000000


DIV_CASES = {
    "plain": ["-numTotalSites", "12", "-numWindowSites", "4",
              "-numWindows", "10", "-setSeed", "9"],
    "percentiles": ["-numTotalSites", "10", "-numWindowSites", "5",
                    "-numWindows", "6", "-lowerPercentile", "0.5",
                    "-upperPercentile", "0.5", "-alpha", "3",
                    "-numAlleles", "8", "-setSeed", "4"],
    "too_many": ["-numTotalSites", "4", "-numWindowSites", "5"],
}


@pytest.mark.parametrize("case", sorted(DIV_CASES))
def test_divergent_windows_equals_jax(tmp_path, capsys, case):
    args = DIV_CASES[case]
    jax, port = _both(tmp_path, capsys, jtools.main_divergent_windows,
                      ttools.main_divergent_windows,
                      lambda o: [o[0], o[1], *args], ["lo.vcf", "up.vcf"])
    assert port == jax
    if case == "too_many":
        assert jax[0] == ("raise", "SystemExit",
                          "The number of total simulated Vcf variants must "
                          "be greater than the desired number of variants "
                          "per window.")


def test_divergent_windows_shuffles_accumulate(tmp_path):
    """Before window w the generator is re-seeded with setSeed * w and
    the one site list is shuffled in place, so window w is the head of
    w + 1 shuffles; windows are sorted stably by their alt-ancestor
    count, the lower file taking the first int(lower * W)."""
    lo, up = str(tmp_path / "lo.vcf"), str(tmp_path / "up.vcf")
    total, k, w, seed = 12, 4, 6, 5
    ttools.main_divergent_windows([lo, up, "-numTotalSites", str(total),
                                   "-numWindowSites", str(k), "-numWindows",
                                   str(w), "-setSeed", str(seed),
                                   "-lowerPercentile", "0",
                                   "-upperPercentile", "0"])
    assert _lines(lo) == []
    rows = [ln.split("\t") for ln in _lines(up)]
    assert len(rows) == w * k
    chunks = [tuple(int(r[1]) for r in rows[i:i + k])
              for i in range(0, len(rows), k)]
    alt = [sum(r[7] == "AA=T" for r in rows[i:i + k])
           for i in range(0, len(rows), k)]
    assert alt == sorted(alt)

    def windows(accumulate):
        sites = list(range(1, total + 1))
        rng = jgr.GoRand(seed)
        out = []
        for i in range(w):
            rng.seed(seed * i)
            s = sites if accumulate else list(sites)

            def swap(a, b, s=s):
                s[a], s[b] = s[b], s[a]

            rng.shuffle(len(s), swap)
            out.append(tuple(s[:k]))
        return out

    assert sorted(chunks) == sorted(windows(True))
    assert sorted(windows(True)) != sorted(windows(False))


# --- simulatePcr ---

def _pcr_ref(tmp_path):
    return _write_fa(tmp_path / "p.fa", {
        "c1": "ttACGTACgggACGTACccGTACGTgggGTACGTaaACGTACACGTACttGTACGT",
        "c2": "ACGTACACGTAC" + "g" * 30 + "GTACGT",
        "c3": "AAAAAAAA"})


PCR_CASES = {
    "plain": ["-p", "ACGTAC", "-bed", "B", "-fastq", "F"],
    "no_primer": ["-p", "ACGTAC", "-bed", "B", "-fastq", "F",
                  "-includePrimer=false"],
    "two_primers": ["-p", "ACGTAC", "-p", "GGG", "-bed", "B"],
    "max_size": ["-p", "ACGTAC", "-bed", "B", "-maxProductSize", "20"],
    "no_limit": ["-p", "ACGTAC", "-fastq", "F", "-maxProductSize", "0"],
    "lower_primer": ["-p", "acgtac", "-bed", "B"],
    "no_output": ["-p", "ACGTAC"],
    "no_p": ["-bed", "B"],
    "include_bare": ["-p", "ACGTAC", "-includePrimer", "-bed", "B"],
}


@pytest.mark.parametrize("case", sorted(PCR_CASES))
def test_simulate_pcr_equals_jax(tmp_path, capsys, case):
    ref = _pcr_ref(tmp_path)
    args = PCR_CASES[case]
    names = [n for n, tag in (("o.bed", "B"), ("o.fq", "F")) if tag in args]

    def argv_of(outs):
        m = dict(zip([t for t in ("B", "F") if t in args], outs))
        return ["-t", ref, *[m.get(a, a) for a in args]]

    jax, port = _both(tmp_path, capsys, jtools.main_pcr, ttools.main_pcr,
                      argv_of, names)
    assert port == jax
    if case == "no_p":
        assert jax[0] == ("raise", "SystemExit",
                          "ERROR: primer sequence must be declared at least "
                          "once using -p")


def test_simulate_pcr_quirks(tmp_path, capsys):
    """The scan steps past each hit; only the last forward site before a
    reverse site makes a product, named primer+<revcomp of the reverse
    site>; FASTQ quals are I; a lower-case primer finds nothing."""
    ref = _pcr_ref(tmp_path)
    b, fq = str(tmp_path / "o.bed"), str(tmp_path / "o.fq")
    ttools.main_pcr(["-p", "ACGTAC", "-t", ref, "-bed", b, "-fastq", fq,
                     "-includePrimer=false"])
    rows = [ln.split("\t") for ln in _lines(b)]
    assert capsys.readouterr().out == f"found {len(rows)} potential products\n"
    assert all(r[3] == "ACGTAC+ACGTAC" for r in rows)
    t = "ttACGTACgggACGTACccGTACGTgggGTACGTaaACGTACACGTACttGTACGT".upper()
    assert [(r[0], int(r[1]), int(r[2])) for r in rows if r[0] == "c1"] == [
        ("c1", t.find("ACGTACcc".upper()) + 6, t.find("GTACGTggg".upper())),
        ("c1", t.rfind("ACGTACtt".upper()) + 6, t.rfind("GTACGT"))]
    fql = _lines(fq)
    assert all(set(q) == {"I"} for q in fql[3::4])
    ttools.main_pcr(["-p", "acgtac", "-t", ref, "-bed", b])
    assert capsys.readouterr().out == "found 0 potential products\n"
    for mod in (jtools, ttools):
        assert mod._find_priming_sites("AAAA", "AA", True) == [("AA", 2),
                                                               ("AA", 4)]
        assert mod._find_priming_sites("AAAA", "AA", False) == [("AA", 0),
                                                                ("AA", 2)]
    fwd, rev = [("AC", 5), ("AC", 9), ("AC", 30)], [("GT", 20), ("GT", 40)]
    for inc in (True, False):
        for mx in (10, 100):
            got = [vars(x) for x in ttools._calc_products("c", fwd, rev, mx,
                                                          inc)]
            assert got == [vars(x) for x in jtools._calc_products(
                "c", fwd, rev, mx, inc)]
