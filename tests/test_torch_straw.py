"""The port's straw reader and strawToBedpe (gonomics_tpu_torch/io/hic.py,
cli/straw_to_bedpe.py) and ``fileio.next_real_line`` on the CPU against
the JAX package.

The straw maps are built here from numpy seeds: contacts at 1 kb bins up
to a few bins apart, scores one more than a negative binomial whose mean
falls with the distance, a few raised as peaks, some with the later bin
first. Every public name of ``io/hic.py`` is held to the JAX's; the
tool's written files (the bedpe, the fit statistics with Go's ``%v``
floats, the score histogram, gzipped or not) and exit messages to the
JAX tool's bytes over its flags; each reference quirk has a case. The
fits take steps of 0.01 where the case is not about the default steps,
so that the coordinate ascent stays short.
"""

import gzip
import io
import os

import numpy as np
import pytest

from gonomics_tpu import fileio as jfileio
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.cli import straw_to_bedpe as jstb
from gonomics_tpu.io import hic as jhic
from gonomics_tpu_torch import fileio as tfileio
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.cli import straw_to_bedpe as tstb
from gonomics_tpu_torch.io import hic as thic

BIN = 1000
FAST = ["-rStep", "0.01", "-pStep", "0.01"]


def _write(path, lines):
    path.write_text("".join(ln + "\n" for ln in lines))
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        data = f.read()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, IndexError) as e:
        return type(e).__name__, str(e)


def straw_lines(seed=3410, bins=40, dists=5, start=0, mean=20.0,
                peaks=0.05, diagonal=True):
    """A straw map: every pair of bins up to dists - 1 apart (from 1
    without the diagonal), scores 1 + NB(2, mean / (1 + d)), a share
    peaks raised by 30-60, a tenth with the later bin first; led by a
    # line."""
    rng = np.random.default_rng(seed)
    out = ["# chr observed NONE BP 1000"]
    for i in range(bins):
        for d in range(0 if diagonal else 1, min(dists, bins - i)):
            m = mean / (1 + d)
            s = 1 + int(rng.negative_binomial(2, 2 / (2 + m)))
            if rng.random() < peaks:
                s += int(rng.integers(30, 60))
            a, b = start + i * BIN, start + (i + d) * BIN
            out.append(f"{b}\t{a}\t{s}" if rng.random() < 0.1 else
                       f"{a}\t{b}\t{s}")
    return out


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("straw")
    out = {
        "chr1.straw": _write(d / "chr1.straw", straw_lines()),
        "chr2.straw": _write(d / "chr2.straw", straw_lines(
            3411, bins=12, dists=4, start=50_000, mean=8.0)),
        "nodiag.straw": _write(d / "nodiag.straw", straw_lines(
            3412, bins=20, dists=4, diagonal=False)),
        "wide.straw": _write(d / "wide.straw", straw_lines(
            3413, bins=20, dists=12, peaks=0.1))}
    gz = d / "chr1.straw.gz"
    gz.write_bytes(gzip.compress(open(out["chr1.straw"], "rb").read()))
    out["chr1.straw.gz"] = str(gz)
    for name, rows in (("one.list", [f"{out['chr1.straw']}\tchr1"]),
                       ("two.list", [f"{out['chr1.straw']}\tchr1",
                                     f"{out['chr2.straw']}\tchr2"]),
                       ("gz.list", [f"{out['chr1.straw.gz']}\tchr1"]),
                       ("nodiag.list", [f"{out['nodiag.straw']}\tchr1"]),
                       ("wide.list", [f"{out['wide.straw']}\tchr1\textra"])):
        out[name] = _write(d / name, rows)
    return out


# --- fileio.next_real_line ---

@pytest.mark.parametrize("text", ["", "# only\n# comments\n",
                                  "#a\n#b\nfirst\n#c\nsecond",
                                  "no newline", "\n#x\nafter blank\n"])
def test_next_real_line_equals_jax(text):
    """The next non-# line without its newline, None at EOF; the handle
    left where the JAX leaves it."""
    got = {}
    for side, mod in (("jax", jfileio), ("port", tfileio)):
        f = io.StringIO(text)
        first, second = mod.next_real_line(f), mod.next_real_line(f)
        got[side] = (first, second, f.read())
    assert got["port"] == got["jax"]


# --- io/hic.py ---

def test_straw_read_equals_jax(maps):
    """read and read_to_iter on a file led by a # line (skipped), and on
    its gzip copy."""
    for name in ("chr1.straw", "chr1.straw.gz"):
        j = [vars(s) for s in jhic.read(maps[name])]
        t = [vars(s) for s in thic.read(maps[name])]
        assert t == j and len(t) > 100
        assert [vars(s) for s in thic.read_to_iter(maps[name])] == j


@pytest.mark.parametrize("lines", [
    ["1000\t2000\t5", "# a comment after the first record", "0\t0\t1"],
    ["0\t1000\t2.5"], ["0\t1000"], ["0 1000 5"], [], ["#", "#only"],
    ["# lead", "#lead", "0\t0\t3", "1000\t3000\t4\textra"]],
    ids=["mid_comment", "float_score", "two_fields", "spaces", "empty",
         "comments_only", "extra_field"])
def test_straw_read_quirks_equal_jax(tmp_path, lines):
    """# lines only before the first record; int() of each field (a float
    score raises ValueError); a short line raises IndexError; fields past
    the third are ignored; as in the JAX."""
    path = _write(tmp_path / "s.straw", lines)

    def read(mod):
        return [vars(s) for s in mod.read(path)]

    j, t = _outcome(read, jhic), _outcome(read, thic)
    assert t == j
    if lines and lines[0] == "0\t1000\t2.5":
        assert t[0] == "ValueError"
    if lines[1:2] == ["# a comment after the first record"]:
        assert t[0] == "ValueError"


@pytest.mark.parametrize("line", ["0\t1000\t7", "5000\t0\t0",
                                  "-1000\t3000\t12"])
def test_process_straw_line_equals_jax(line):
    assert vars(thic.process_straw_line(line)) == \
        vars(jhic.process_straw_line(line))


@pytest.mark.parametrize("a,b", [((0, 1000, 3), (0, 1000, 3)),
                                 ((0, 1000, 3), (1000, 0, 3)),
                                 ((0, 1000, 3), (0, 1000, 4)),
                                 ((0, 1000, 3), (0, 2000, 3))])
def test_straw_equal_equals_jax(a, b):
    """equal ignores the order of the two bins."""
    assert thic.equal(thic.Straw(*a), thic.Straw(*b)) == \
        jhic.equal(jhic.Straw(*a), jhic.Straw(*b))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_straw_all_are_equal_equals_jax(n):
    """all_are_equal, and its ValueError on lists of unequal length."""
    base = [(0, 1000, 3), (2000, 1000, 5)]
    for other in (base[:n], [(1000, 0, 3), (1000, 2000, 5)][:n],
                  [(1000, 0, 3), (1000, 2000, 6)][:n], base[:1]):
        j = _outcome(jhic.all_are_equal, [jhic.Straw(*x) for x in base[:n]],
                     [jhic.Straw(*x) for x in other])
        t = _outcome(thic.all_are_equal, [thic.Straw(*x) for x in base[:n]],
                     [thic.Straw(*x) for x in other])
        assert t == j


# --- strawToBedpe ---

def _run(mod, argv, d):
    d.mkdir()
    res = _outcome(mod.main, ["strawToBedpe"] + [
        a.replace("@", str(d) + "/") for a in argv])
    return res, {n: _read(str(d / n)) for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("lst,flags", [
    ("one.list", ["-binSize", "1000", "-fitStatsFile", "@fit.txt",
                  "-contactScoreFile", "@scores.txt"]),
    ("one.list", ["-binSize", "1000", "-minBinDistance", "2",
                  "-fitStatsFile", "@fit.txt", "-contactScoreFile",
                  "@scores.txt.gz", "-maxContactScoreInDistributionFile",
                  "30", "-maxBinDistanceInDistributionFile", "3", *FAST]),
    ("two.list", ["-binSize", "1000", "-fitStatsFile", "@fit.txt",
                  "-minCutoff", "3", "-fdr", "0.2", *FAST]),
    ("gz.list", ["-binSize", "1000", "-rStart", "2.5", "-pStart", "0.2",
                 "-fitStatsFile", "@fit.txt", *FAST]),
    ("nodiag.list", ["-binSize", "1000", "-fitStatsFile", "@fit.txt",
                     "-contactScoreFile", "@scores.txt", *FAST]),
    ("wide.list", ["-binSize", "1000", "-minCutoff", "2",
                   "-fitStatsFile", "@fit.txt", *FAST]),
    ("one.list", ["-binSize", "2000", *FAST]),
    ("one.list", ["-binSize", "1000", "-rStart", "0", *FAST]),
    ("one.list", ["-binSize", "1000", "-pStart", "1", *FAST])],
    ids=["default_steps", "min_bin_distance", "two_chroms_low_cutoff",
         "gzip_start_values", "no_diagonal", "wide_low_cutoff",
         "bin_not_multiple", "r_start_zero", "p_start_one"])
def test_straw_to_bedpe_equals_jax(maps, tmp_path, capsys, lst, flags):
    """strawToBedpe through the umbrella: the bedpe, the fit statistics
    and the score histogram byte for byte (gzip decompressed), and the
    exits: a distance that is no multiple of -binSize, and the fit's
    refusal of its start values."""
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        out[side] = (*_run(mod, [maps[lst], "@out.bedpe", *flags],
                           tmp_path / side), capsys.readouterr().out)
    assert out["port"] == out["jax"]
    res, written, _ = out["port"]
    if "2000" in flags:
        assert res == ("SystemExit", "Error: Distance between two straw "
                       "ends: 1000 is not a multiple of the bin size: 2000.")
    elif "-rStart" in flags and "0" in flags or "-pStart" in flags and \
            "1" in flags:
        assert res[0] == "ValueError"
    else:
        assert res[0] == "ok" and written["out.bedpe"]
    if "scores.txt" in written:
        assert written["scores.txt"].startswith(
            b"BinDistance\tScore\tCount\n\n")
    if lst == "nodiag.list":
        # distance 0 has no contacts: it fits [0], its cutoff stays at
        # -minCutoff and the fits stop there
        assert written["fit.txt"].decode().splitlines()[1:] == [
            "0\t1\t0.5\t10"]


def test_straw_to_bedpe_reads_each_file_twice(maps, tmp_path,
                                              monkeypatch):
    """Each straw file is read twice, once for the histogram and once to
    write, in both packages."""
    calls = {}
    for side, mod in (("jax", jstb), ("port", tstb)):
        seen = []
        real = mod.hic.read_to_iter
        monkeypatch.setattr(mod.hic, "read_to_iter",
                            lambda path, real=real, seen=seen:
                            seen.append(path) or real(path))
        mod.straw_to_bedpe(mod.Settings(
            file_list=maps["two.list"], out_file=str(tmp_path / f"{side}.b"),
            bin_size=BIN, r_step=0.01, p_step=0.01))
        calls[side] = seen
    assert calls["port"] == calls["jax"] == [
        maps["chr1.straw"], maps["chr2.straw"]] * 2


def test_straw_to_bedpe_helpers_equal_jax(maps, tmp_path):
    """Settings' defaults, _bin_distance, _comparison_counts (negative
    where a chrom's span is shorter than the distance), _bh_cutoffs and
    _print_contact_scores called directly."""
    assert vars(tstb.Settings("a", "b")) == vars(jstb.Settings("a", "b"))
    got = {}
    cache = [[0, 3, 1], None, [0, 0, 0, 2] + [1] * 20, [0, 5]]
    mins, maxes = {"chr1": 0, "chr2": 50_000}, {"chr1": 2000, "chr2": 52_000}
    for side, mod in (("jax", jstb), ("port", tstb)):
        s = mod.Settings("x", "y", bin_size=BIN, r_step=0.01, p_step=0.01,
                         min_cutoff=2, fit_stats_file=str(tmp_path /
                                                          f"{side}.fit"),
                         contact_score_file=str(tmp_path / f"{side}.sc"),
                         max_bin_distance_in_distribution_file=4,
                         max_contact_score_in_distribution_file=6)
        comps = mod._comparison_counts(cache, mins, maxes, s)
        cuts = mod._bh_cutoffs(cache, s, comps)
        mod._print_contact_scores(cache, s)
        dists = [_outcome(mod._bin_distance, mod.hic.Straw(a, b, 1), BIN)
                 for a, b in ((0, 3000), (3000, 0), (0, 1500))]
        got[side] = (comps, cuts, dists, _read(str(tmp_path / f"{side}.fit")),
                     _read(str(tmp_path / f"{side}.sc")))
    assert got["port"] == got["jax"]
    assert min(got["port"][0]) < 0
