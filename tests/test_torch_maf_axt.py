"""The port's MAF and axt tools (``mafFilter``, ``mafToBed``,
``mafToMultiFa``, ``mafIndels``, gonomics_tpu_torch/cli/maf_tools.py;
``axTools``, cli/ax_tools.py; ``axtSam``, cli/axt_sam.py) on the CPU
against the JAX tools: the bytes of every file they write (a BAM as its
payload under the BGZF blocks), their stdout, and the message of every
exit, on inputs that a numpy seed builds here: pairwise and three-way
MAFs of a target chr1 (gapped rows, lower case, both strands, i lines,
e lines of each status, comments, single-species blocks) and malformed
ones, axt files of plus and minus queries with gaps, N and lower case,
and their target FASTA, sizes and beds. Each quirk of the reference that
the port keeps is pinned by a case here. Also the library under them:
``maf.read``, ``write`` and ``to_fasta``; ``formats.swap_axt`` on both
strands, ``pair_seq_to_cigar``, ``axt_to_sam`` and the percent identity;
``sam.generate_header``; against the JAX's, floats by their 64 bits.
"""

import contextlib
import copy
import gzip
import io
import os
import struct

import numpy as np
import pytest

from gonomics_tpu.cli import ax_tools as jax_tools
from gonomics_tpu.cli import axt_sam as jaxt_sam
from gonomics_tpu.cli import maf_tools as jmaf_tools
from gonomics_tpu.io import chrom_info as jchrom_info
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.io import formats as jformats
from gonomics_tpu.io import maf as jmaf
from gonomics_tpu.io import sam as jsam
from gonomics_tpu_torch import dna
from gonomics_tpu_torch.cli import ax_tools, axt_sam, maf_tools
from gonomics_tpu_torch.io import chrom_info, fasta, formats, maf, sam

TOOLS = {"mafFilter": (jmaf_tools.main_filter, maf_tools.main_filter),
         "mafToBed": (jmaf_tools.main_to_bed, maf_tools.main_to_bed),
         "mafToMultiFa": (jmaf_tools.main_to_multi_fa,
                          maf_tools.main_to_multi_fa),
         "mafIndels": (jmaf_tools.main_indels, maf_tools.main_indels),
         "axTools": (jax_tools.main, ax_tools.main),
         "axtSam": (jaxt_sam.main, axt_sam.main)}

T_LEN = 3000


def _payload(data: bytes) -> bytes:
    """A BAM's payload; any other file's bytes."""
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


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
        except Exception as e:  # the JAX tools' AttributeError, ...
            exit_msg = f"{type(e).__name__}: {e}"
        files = {}
        for n in sorted(os.listdir(d)):
            with open(os.path.join(d, n), "rb") as f:
                files[n] = _payload(f.read())
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


# --- MAF inputs


def _maf_text(rng, target: str, n_blocks: int, three: bool,
              single_every: int = 0) -> list[str]:
    """A MAF of n_blocks non-overlapping blocks on t.chr1 (T_LEN bases),
    in target order: the t row gapped where q inserts, the q row mutated,
    lower-cased now and then and gapped where it deletes; q on either
    strand; i lines for q; with three, an r species as an s line, an e
    line of any status, or absent. Every single_every-th block holds the
    target alone. Comments between blocks."""
    out = ["##maf version=1 scoring=test", "# a comment"]
    cuts = np.sort(rng.choice(np.arange(10, T_LEN - 100, 40), n_blocks,
                              replace=False))
    q_pos = 0
    for k, start in enumerate(cuts.tolist()):
        size = int(rng.integers(8, 36))
        t_row, q_row = [], []
        for b in target[start:start + size]:
            if rng.random() < 0.08:
                k_ins = int(rng.integers(1, 3))
                t_row += ["-"] * k_ins
                q_row += list(rng.choice(list("ACGT"), k_ins))
            t_row.append(b)
            r = rng.random()
            q_row.append("-" if r < 0.06 else
                         str(rng.choice(list("ACGT"))) if r < 0.16 else b)
        if rng.random() < 0.3:
            q_row = [c.lower() for c in q_row]
        if rng.random() < 0.2:
            t_row = [c.lower() for c in t_row]
        q_size = sum(c != "-" for c in q_row)
        score = float(rng.integers(-500, 5000)) / (4 if k % 3 else 1)
        out.append(f"a score={score}" + (" pass=2" if k % 4 == 1 else ""))
        out.append(f"s t.chr1 {start} {size} + {T_LEN} {''.join(t_row)}")
        if single_every and k % single_every == 0:
            out.append("")
            continue
        strand = "+" if rng.random() < 0.7 else "-"
        out.append(f"s q.chr1 {q_pos} {q_size} {strand} 5000 "
                   f"{''.join(q_row)}")
        st = "CINnMT"
        out.append(f"i q.chr1 {st[int(rng.integers(0, 6))]} "
                   f"{int(rng.integers(0, 50))} {st[int(rng.integers(0, 6))]}"
                   f" {int(rng.integers(0, 50))}")
        q_pos += q_size + int(rng.integers(0, 20))
        if three:
            r = rng.random()
            if r < 0.45:
                row = "".join(str(rng.choice(list("ACGT-"))) for _ in t_row)
                out.append(f"s r.chrX {5 * k} {sum(c != '-' for c in row)} "
                           f"- 900 {row}")
            elif r < 0.9:
                out.append(f"e r.chrX {7 * k} {int(rng.integers(1, 60))} + "
                           f"900 {'CIMnT'[int(rng.integers(0, 5))]}")
        out.append("")
        if k % 5 == 2:
            out.append("# between blocks")
    return out


def _pairwise_e_text(rng, n_blocks: int) -> list[str]:
    """A pairwise MAF where q appears only as an e line after the target's
    s line, with status C, I or another, sizes around the target's."""
    out = ["##maf version=1"]
    for k in range(n_blocks):
        size = int(rng.integers(10, 200))
        out.append(f"a score={float(rng.integers(0, 900))}")
        out.append(f"s t.chr{1 + k % 2} {100 * k} {size} + {T_LEN} "
                   + "".join(rng.choice(list("ACGT"), size)))
        out.append(f"e q.chr{1 + k % 3} {50 * k} "
                   f"{int(rng.integers(0, 2 * size))} "
                   f"{'+-'[k % 2]} 4000 {'CIIMnT'[k % 6]}")
        out.append("")
    return out


@pytest.fixture(scope="module")
def mafs(tmp_path_factory):
    d = tmp_path_factory.mktemp("maf")
    rng = np.random.default_rng(3101)
    target = "".join(rng.choice(list("ACGTacgt"), T_LEN))
    files = {
        "pair.maf": _maf_text(rng, target, 30, False),
        "three.maf": _maf_text(rng, target, 25, True),
        "single.maf": _maf_text(rng, target, 12, False, single_every=2),
        "e.maf": _pairwise_e_text(rng, 40),
        "t.fa": [">chr1", target],
        "t_short.fa": [">chr1", target[:-1]],
        "t_two.fa": [">chr1", target, ">chr2", target[:50]],
        "species_tq.txt": ["t", "q"],
        "species_tqr.txt": ["t", "q", "r"],
        "species_tz.txt": ["t", "z"],
        "species_qt.txt": ["q", "t"],
        "species_zt.txt": ["z", "t"],
        "t_mismatch.fa": [">chr1", "".join(
            "ACGT"[("ACGT".index(c.upper()) + 1) % 4] if i % 7 == 0 else c
            for i, c in enumerate(target))]}
    # malformed MAFs, each read to its exit
    good = files["pair.maf"]
    bad = {
        "bad_no_blank_end.maf": good[:-1],
        "bad_no_blank_between.maf": [ln for i, ln in enumerate(good)
                                     if i != good.index("")],
        "bad_unexpected.maf": good[:6] + ["q what"] + good[6:],
        "bad_i_status.maf": ["a score=1",
                             "s t.chr1 0 3 + 3000 ACG",
                             "i q.chr1 X 0 C 0", ""],
        "bad_e_status.maf": ["a score=1", "s t.chr1 0 3 + 3000 ACG",
                             "e q.chr1 0 3 + 40 n", "e r.chr1 0 3 + 40 N",
                             ""],
        "bad_s_fields.maf": ["a score=1", "s t.chr1 0 3 + 3000", ""],
        "bad_s_twice.maf": ["a score=1", "s t.chr1 0 3 + 3000 ACG",
                            "s t.chr1 0 3 + 3000 ACG", ""],
        "bad_no_a.maf": ["s t.chr1 0 3 + 3000 ACG", ""],
        "bad_dots.maf": ["a score=1", "s t.chr1.x 0 3 + 3000 ACG", ""],
        "odd_a.maf": ["abc score=2.5", "s t.chr1 0 3 + 3000 ACG",
                      "s q.chr1 0 3 + 30 ACG", "", "a",
                      "s t.chr1 10 2 + 3000 AC", "", "# trailing comment"]}
    files.update(bad)
    out = {k: _write(d / k, v) for k, v in files.items()}
    out["target"] = target
    return out


MAF_INPUTS = ["pair.maf", "three.maf", "single.maf", "e.maf", "odd_a.maf"]
BAD_MAFS = ["bad_no_blank_end.maf", "bad_no_blank_between.maf",
            "bad_unexpected.maf", "bad_i_status.maf", "bad_e_status.maf",
            "bad_s_fields.maf", "bad_s_twice.maf", "bad_no_a.maf"]


@pytest.mark.parametrize("name", MAF_INPUTS + BAD_MAFS)
@pytest.mark.parametrize("threshold", [None, "0", "500.5", "-900.25"])
def test_maf_filter(mafs, tmp_path, name, threshold):
    """Blocks at or above the threshold (0 by default), written with only
    a and s lines, score .1f and each block's widths; every malformed
    MAF exits with the reader's message."""
    flags = [] if threshold is None else ["-threshold", threshold]
    got = _both(tmp_path, "mafFilter",
                lambda d: [mafs[name], d + "/out.maf", *flags])
    if name.startswith("bad"):
        assert got["exit"] and not got["files"]
    else:
        text = got["files"]["out.maf"].decode()
        assert text.startswith("##maf version=1\n")
        assert "\ni " not in text and "\ne " not in text


@pytest.mark.parametrize("name", MAF_INPUTS + ["bad_dots.maf"])
@pytest.mark.parametrize("ref", ["t", "q", "r", "zz"])
def test_maf_to_bed(mafs, tmp_path, name, ref):
    """The reference species' last s line of a block, named with every
    assembly of the block joined by ';', score int(score), 5 fields; a
    src with two dots exits."""
    got = _both(tmp_path, "mafToBed",
                lambda d: [mafs[name], d + "/out.bed", ref])
    if name == "bad_dots.maf":
        assert got["exit"].startswith("Error: too many dots")
    elif name == "pair.maf" and ref == "t":
        rows = [ln.split("\t") for ln in _lines(got, "out.bed")]
        assert len(rows) == 30 and all(len(r) == 5 for r in rows)
        assert {r[3] for r in rows} == {"t;q"}


def test_maf_to_bed_last_s_line(tmp_path):
    """Two s lines of the reference species in one block: the last one
    is the record."""
    src = _write(tmp_path / "two.maf", [
        "a score=7.9", "s t.chr1 0 3 + 3000 ACG", "s q.chr2 4 3 + 40 ACG",
        "s t.chr5 10 3 + 3000 ACG", ""])
    got = _both(tmp_path, "mafToBed", lambda d: [src, d + "/o.bed", "t"])
    assert _lines(got, "o.bed") == ["chr5\t10\t13\tt;q;t\t7"]


@pytest.mark.parametrize("name,fa,species,no_mask", [
    ("pair.maf", "t.fa", "species_tq.txt", False),
    ("pair.maf", "t.fa", "species_tq.txt", True),
    ("three.maf", "t.fa", "species_tqr.txt", False),
    ("three.maf", "t.fa", "species_tqr.txt", True),
    ("single.maf", "t.fa", "species_tqr.txt", False),
    ("pair.maf", "t.fa", "species_tz.txt", False),
    ("pair.maf", "t_short.fa", "species_tq.txt", False),
    ("pair.maf", "t_two.fa", "species_tq.txt", False),
    ("pair.maf", "t_mismatch.fa", "species_tq.txt", False),
    ("pair.maf", "t.fa", "species_qt.txt", False),
    ("pair.maf", "t.fa", "species_zt.txt", False)])
def test_maf_to_multi_fa(mafs, tmp_path, name, fa, species, no_mask):
    """The blocks spliced into the target, gaps for a species a block
    lacks, -noMask upper-casing; the FASTA's length checked against the
    first block, its bases against each block's target row (so the query
    as the first species exits); a FASTA of two records exits; a first
    species missing from a block raises AttributeError."""
    flags = ["-noMask"] if no_mask else []
    got = _both(tmp_path, "mafToMultiFa", lambda d: [
        mafs[name], mafs[fa], mafs[species], d + "/out.fa", *flags])
    if fa == "t.fa" and species not in ("species_qt.txt",
                                        "species_zt.txt"):
        assert got["exit"] is None
        recs = fasta.read(str(tmp_path / "port" / "out.fa"))
        gapless = recs[0].seq[recs[0].seq != dna.GAP]
        want = dna.from_string(mafs["target"])
        assert np.array_equal(dna.to_upper(gapless), dna.to_upper(want))
        if no_mask:
            assert np.array_equal(gapless, dna.to_upper(want))
    elif species == "species_zt.txt":
        assert got["exit"].startswith("AttributeError")
    else:
        assert got["exit"].startswith("Error")


def test_maf_to_multi_fa_checks_first_block_in_file_order(tmp_path):
    """The length check reads the first block as written, before the
    sort: a first block whose src size is not the FASTA's exits though a
    later block's is."""
    fa = _write(tmp_path / "t.fa", [">chr1", "ACGTACGTAC"])
    species = _write(tmp_path / "sp.txt", ["t", "q"])
    src = _write(tmp_path / "o.maf", [
        "a score=1", "s t.chr1 6 2 + 11 GT", "s q.c 0 2 + 9 GA", "",
        "a score=2", "s t.chr1 0 3 + 10 ACG", "s q.c 3 3 + 9 AAG", ""])
    got = _both(tmp_path, "mafToMultiFa",
                lambda d: [src, fa, species, d + "/o.fa"])
    assert got["exit"].startswith("Error: ref seq supplied as fasta")


@pytest.mark.parametrize("name,ins,dele,thr", [
    ("e.maf", "t", "q", None), ("e.maf", "t", "q", "0.5"),
    ("e.maf", "t", "q", "1.5"), ("e.maf", "t", "zz", None),
    ("e.maf", "q", "t", None), ("three.maf", "t", "r", "2"),
    ("single.maf", "zz", "q", None), ("pair.maf", "t", "q", None)])
def test_maf_indels(mafs, tmp_path, name, ins, dele, thr):
    """eC for a C e line, eI where an I e line is shorter than threshold
    times the target's size; a wrong species_ins exits, but only in a
    block of two or more species."""
    flags = [] if thr is None else ["-eiThreshold", thr]
    got = _both(tmp_path, "mafIndels", lambda d: [
        mafs[name], ins, dele, d + "/ins.bed", d + "/del.bed", *flags])
    if ins != "t":
        assert got["exit"].startswith("species_ins was incorrect")
    elif name == "e.maf" and dele == "q":
        tags = {ln.split("\t")[3] for ln in _lines(got, "ins.bed")}
        assert "ins_eC" in tags
        if thr == "1.5":
            assert "ins_eI" in tags


def test_maf_indels_single_species_does_not_check(tmp_path):
    src = _write(tmp_path / "s.maf", [
        "a score=3", "s t.chr1 0 3 + 3000 ACG", "",
        "a score=4", "s t.chr1 5 3 + 3000 ACG", ""])
    got = _both(tmp_path, "mafIndels", lambda d: [
        src, "wrong", "q", d + "/i.bed", d + "/d.bed"])
    assert got["exit"] is None
    assert got["files"] == {"d.bed": b"", "i.bed": b""}


def _maf_key(blocks) -> list:
    """The blocks as plain values, sequences as strings."""
    out = []
    for m in blocks:
        sps = []
        for sp in m.species:
            s = sp.s_line
            sps.append((sp.src, None if s is None else (
                s.src, s.start, s.size, s.strand, s.src_size,
                dna.to_string(s.seq)),
                None if sp.i_line is None else tuple(vars(sp.i_line).values()),
                None if sp.e_line is None
                else tuple(vars(sp.e_line).values())))
        out.append((struct.pack("<d", m.score), sps))
    return out


@pytest.mark.parametrize("name", MAF_INPUTS)
def test_maf_read_write_to_fasta_equal_jax(mafs, tmp_path, name):
    """maf.read's blocks, write's bytes, sort_by_pos_rev's order and
    to_fasta's rows against the JAX's."""
    jb, tb = jmaf.read(mafs[name]), maf.read(mafs[name])
    assert _maf_key(jb) == _maf_key(tb)
    jmaf.write(str(tmp_path / "j.maf"), jb)
    maf.write(str(tmp_path / "t.maf"), tb)
    assert (tmp_path / "j.maf").read_bytes() == \
        (tmp_path / "t.maf").read_bytes()
    jmaf.sort_by_pos_rev(jb)
    maf.sort_by_pos_rev(tb)
    assert _maf_key(jb) == _maf_key(tb)
    if name in ("pair.maf", "three.maf", "single.maf"):
        jref = jfasta.read(mafs["t.fa"])[0]
        tref = fasta.read(mafs["t.fa"])[0]
        ja = jmaf.to_fasta(jb, jref, ["t", "q", "r"])
        ta = maf.to_fasta(tb, tref, ["t", "q", "r"])
        assert [(r.name, dna.to_string(r.seq)) for r in ja] == [
            (r.name, dna.to_string(r.seq)) for r in ta]
    for src in ("t.chr1", "a", "x.y"):
        assert jmaf.src_to_assembly_and_chrom(src) == \
            maf.src_to_assembly_and_chrom(src)


# --- axt inputs


def _axt_rows(rng, target: dict, n: int, gaps: bool, ns: bool) -> list:
    """n axt records on the target: the query row mutated (10%), N (3%)
    and lower-cased now and then; with gaps, deletions and insertions of
    the query; with ns, N in the target row of every third record; a
    quarter on the minus strand of chrQ (5,000 bases)."""
    out = []
    q_at = 1
    for k in range(n):
        chrom = sorted(target)[k % len(target)]
        size = int(rng.integers(15, 60))
        start = int(rng.integers(0, len(target[chrom]) - size))
        t_row, q_row = [], []
        for b in target[chrom][start:start + size]:
            if gaps and rng.random() < 0.05:
                t_row.append("-")
                q_row.append(str(rng.choice(list("ACGT"))))
            t_row.append("N" if ns and k % 3 == 0 and rng.random() < 0.1
                         else b)
            r = rng.random()
            q_row.append("-" if gaps and r < 0.05 else
                         "N" if r < 0.08 else
                         str(rng.choice(list("ACGT"))) if r < 0.18 else b)
        if rng.random() < 0.2:
            q_row = [c.lower() for c in q_row]
        q_size = sum(c != "-" for c in q_row)
        strand = "-" if k % 4 == 3 else "+"
        out.append((f"chr{chrom}" if not chrom.startswith("chr") else chrom,
                    start + 1, start + size, "chrQ", q_at, q_at + q_size - 1,
                    strand, int(rng.integers(-50, 900)), "".join(t_row),
                    "".join(q_row)))
        q_at += q_size + int(rng.integers(0, 30))
    return out


def _axt_lines(rows, header: bool = True) -> list[str]:
    out = ["##matrix=test", "# a comment"] if header else []
    for k, (tn, ts, te, qn, qs, qe, st, sc, tr, qr) in enumerate(rows):
        out += [f"{k} {tn} {ts} {te} {qn} {qs} {qe} {st} {sc}", tr, qr, ""]
    return out


@pytest.fixture(scope="module")
def axts(tmp_path_factory):
    d = tmp_path_factory.mktemp("axt")
    rng = np.random.default_rng(3102)
    target = {c: "".join(rng.choice(list("ACGT"), n))
              for c, n in (("chr1", 1500), ("chr2", 700))}
    gapped = _axt_rows(rng, target, 30, gaps=True, ns=True)
    plain = _axt_rows(rng, target, 20, gaps=False, ns=True)
    files = {
        "g.axt": _axt_lines(gapped),
        "p.axt": _axt_lines(plain, header=False),
        "t.fa": [x for c in target for x in (f">{c}", target[c])],
        "t.sizes": [f"{c}\t{len(s)}" for c, s in target.items()],
        "q.sizes": ["chrQ\t5000"],
        "regions.bed": ["chr1\t100\t400", "chr1\t900\t1000",
                        "chr2\t0\t50"],
        "gapgap.axt": ["0 chr1 1 4 chrQ 1 4 + 5", "AC-GT", "AC-GT", ""]}
    out = {k: _write(d / k, v) for k, v in files.items()}
    out["target"] = target
    return out


AX_CASES = {
    "gap": ["--gap", "p.axt"],
    "gap_gapped": ["--gap", "g.axt"],
    "fasta": ["--fasta", "t.fa", "p.axt"],
    "fasta_gapped_target": ["--fasta", "t.fa", "g.axt"],
    "swap": ["--swap", "--tLen", "t.sizes", "--qLen", "q.sizes", "g.axt"],
    "min_score": ["--minScore", "300", "g.axt"],
    "min_score_negative": ["--minScore", "-10", "p.axt"],
    "stats": ["--stats", "--bedfile", "OUT", "g.axt", "regions.bed"],
    "stats_all": ["--stats", "--bedfile", "OUT", "p.axt", ""],
    "stats_gap_gap": ["--stats", "--bedfile", "OUT", "gapgap.axt", ""],
    "bedfile_alone": ["--bedfile", "x.bed", "g.axt"],
    "none": ["g.axt"],
    "gap_first": ["--gap", "--swap", "--minScore", "300", "p.axt"]}


@pytest.mark.parametrize("case", sorted(AX_CASES))
def test_ax_tools(axts, tmp_path, case):
    """Each operation, the first set of --gap, --fasta, --swap, --minScore
    and --stats in that order; --stats reads the positional output as
    the bed and writes the --bedfile; -bedfile alone and no operation
    exit; a gapped target row exits --fasta; gap against gap raises."""
    def argv(d):
        args = [axts[a] if a in axts else a for a in AX_CASES[case]]
        args = [d + "/stats.txt" if a == "OUT" else a for a in args]
        if case.startswith("stats"):
            return args
        return args + [d + "/out"]
    got = _both(tmp_path, "axTools", argv)
    if case in ("bedfile_alone", "none"):
        assert got["exit"] in ("ERROR: -bedfile must be used with -stats.",
                               "no operation selected")
    elif case == "fasta_gapped_target":
        assert got["exit"] == "Error: Sequence length is not the same..."
    elif case == "stats_gap_gap":
        assert got["exit"] == "ValueError: Gaps aligned to each other"
    elif case == "stats":
        rows = _lines(got, "stats.txt")
        assert rows[0] == "length\tpercentIdentity" and len(rows) > 1
    elif case.startswith("gap"):
        kept = _lines(got, "out")
        assert kept and all("N" in kept[i + 1] and "N" not in kept[i + 2]
                            for i in range(0, len(kept), 4))
    else:
        assert got["exit"] is None and got["files"]


@pytest.mark.parametrize("header", ["chrom", "fasta", "none"])
@pytest.mark.parametrize("out", ["out.sam", "out.bam"])
@pytest.mark.parametrize("src", ["g.axt", "p.axt"])
def test_axt_sam(axts, tmp_path, header, out, src):
    """A record a block: =/X/I/D runs, POS the target start, TLEN r_end -
    r_start, MAPQ 255, flag 16 on minus, SEQ the query without gaps,
    AS/XS/XE; @SQ lines from --chrom or --fasta, else no header; .bam
    written as BAM."""
    flags = {"chrom": ["--chrom", axts["t.sizes"]],
             "fasta": ["--fasta", axts["t.fa"]], "none": []}[header]
    got = _both(tmp_path, "axtSam",
                lambda d: [*flags, axts[src], f"{d}/{out}"])
    assert got["exit"] is None
    if out == "out.sam":
        lines = _lines(got, "out.sam")
        body = [ln.split("\t") for ln in lines if not ln.startswith("@")]
        assert len(body) == (30 if src == "g.axt" else 20)
        assert all(r[4] == "255" and r[11].startswith("AS:i:") for r in body)
        assert (lines[0] == "@HD\tVN:1.6\tSO:unsorted") == (header != "none")
    else:
        assert got["files"][out].startswith(b"BAM\x01")


# --- the library against the JAX's


def _axt_pair(rows):
    j = [jformats.Axt(r[0], r[1], r[2], r[3], r[4], r[5], r[6] == "+", r[7],
                      jformats.dna.from_string(r[8]),
                      jformats.dna.from_string(r[9])) for r in rows]
    t = [formats.Axt(r[0], r[1], r[2], r[3], r[4], r[5], r[6] == "+", r[7],
                     dna.from_string(r[8]), dna.from_string(r[9]))
         for r in rows]
    return j, t


def _axt_key(a) -> tuple:
    return (a.r_name, a.r_start, a.r_end, a.q_name, a.q_start, a.q_end,
            a.q_strand_pos, a.score, dna.to_string(a.r_seq),
            dna.to_string(a.q_seq), a.chrom, a.chrom_start, a.chrom_end)


def test_axt_library_equal_jax():
    """swap_axt on both strands (names and coordinates exchanged, the
    rows left in place, reverse-complemented on minus),
    pair_seq_to_cigar, axt_to_sam and the percent identity over whole
    records and sub-intervals."""
    rng = np.random.default_rng(3103)
    target = {"chr1": "".join(rng.choice(list("ACGT"), 900))}
    rows = _axt_rows(rng, target, 40, gaps=True, ns=True)
    ja, ta = _axt_pair(rows)
    assert any(not a.q_strand_pos for a in ta)
    for j, t in zip(ja, ta):
        assert _axt_key(j) == _axt_key(t)
        jc = jformats.pair_seq_to_cigar(j.r_seq, j.q_seq)
        tc = formats.pair_seq_to_cigar(t.r_seq, t.q_seq)
        assert [(c.run_length, c.op) for c in jc] == [
            (c.run_length, c.op) for c in tc]
        assert jformats.axt_to_sam(j).to_string() == \
            formats.axt_to_sam(t).to_string()
        for s, e in ((j.chrom_start, j.chrom_end),
                     (j.chrom_start + 3, j.chrom_end - 5),
                     (j.chrom_start + 1, j.chrom_start + 2)):
            assert jformats._axt_ref_idx_range(j, s, e) == \
                formats._axt_ref_idx_range(t, s, e)
            jp = jformats.axt_percent_identity_in_interval(j, s, e)
            tp = formats.axt_percent_identity_in_interval(t, s, e)
            assert struct.pack("<d", jp) == struct.pack("<d", tp)
        r_before, q_before = dna.to_string(t.r_seq), dna.to_string(t.q_seq)
        jformats.swap_axt(j, 900, 5000)
        formats.swap_axt(t, 900, 5000)
        assert _axt_key(j) == _axt_key(t)
        assert (t.r_name, t.q_name) == ("chrQ", "chr1")
        if t.q_strand_pos:
            assert (dna.to_string(t.r_seq), dna.to_string(t.q_seq)) == (
                r_before, q_before)
        else:
            assert dna.to_string(t.r_seq) == dna.to_string(
                dna.reverse_complement(dna.from_string(r_before)))
    for fn in (jformats.pair_seq_to_cigar, formats.pair_seq_to_cigar):
        with pytest.raises(ValueError, match="gap aligned to gap"):
            fn(dna.from_string("A-C"), dna.from_string("A-G"))


def test_write_axt_equal_jax(axts, tmp_path):
    jr = jformats.read_axt(axts["g.axt"])
    tr = formats.read_axt(axts["g.axt"])
    jformats.write_axt(str(tmp_path / "j.axt"), jr[::-1])
    formats.write_axt(str(tmp_path / "t.axt"), tr[::-1])
    assert (tmp_path / "j.axt").read_bytes() == \
        (tmp_path / "t.axt").read_bytes()


@pytest.mark.parametrize("sort_order,grouping,additional", [
    ("unsorted", "", None), ("coordinate", "none", None),
    ("queryname", "query", ["@PG\tID:x\tPN:y"]),
    ("coordinate", "reference", ["@CO\tfree text"])])
def test_generate_header_equal_jax(sort_order, grouping, additional):
    chroms = [("chr1", 1500, 0), ("chr2", 700, 1), ("chrM", 16, 2)]
    jh = jsam.generate_header([jchrom_info.ChromInfo(*c) for c in chroms],
                              additional, sort_order, grouping)
    th = sam.generate_header([chrom_info.ChromInfo(*c) for c in chroms],
                             copy.copy(additional), sort_order, grouping)
    assert th.text == jh.text
    assert [(c.name, c.size, c.order) for c in th.chroms] == [
        (c.name, c.size, c.order) for c in jh.chroms]
    assert (th.sort_order, th.grouping) == (jh.sort_order, jh.grouping)
    assert ("GO:" in th.text[0]) == (grouping not in ("", "none"))


def test_count_base_and_read_to_map_equal_jax(axts):
    from gonomics_tpu import dna as jdna

    seq = dna.from_string("ACGTNNacgtn--N")
    for b in range(13):
        assert dna.count_base(seq, b) == jdna.count_base(seq, b)
    jm, tm = jfasta.read_to_map(axts["t.fa"]), fasta.read_to_map(axts["t.fa"])
    assert list(jm) == list(tm)
    assert all(np.array_equal(jm[k], tm[k]) for k in jm)
