"""The port's acceleration tools (``multiFaAcceleration``,
``branchLengthsMultiFaBed``; gonomics_tpu_torch/cli/) on the CPU against
the JAX tools: the bytes of every file they write, their stdout, and the
message of every exit, on four-way alignments (hum, chimp, gor, orang) of
200-400 columns that a numpy seed builds here, with gap runs, lower case
and a stretch where hum's row mutates fast, and windows of 20-50 bases.
Each quirk of the reference that the port keeps is pinned by a case
here. Also the library under them: every public name of
``phylo/accel.py`` against the JAX's, floats compared by their 64 bits,
with and without ``allow_negative`` and ``cavalli``, and with a zero
distance.
"""

import contextlib
import io
import os
import struct
import sys

import numpy as np
import pytest

from gonomics_tpu.cli import branch_lengths_multi_fa_bed as jbranch
from gonomics_tpu.cli import multi_fa_acceleration as jaccel_cli
from gonomics_tpu.io import fasta as jfasta
from gonomics_tpu.phylo import accel as jaccel
from gonomics_tpu_torch.cli import branch_lengths_multi_fa_bed as branch
from gonomics_tpu_torch.cli import multi_fa_acceleration as accel_cli
from gonomics_tpu_torch.io import fasta
from gonomics_tpu_torch.phylo import accel

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import accel_fit_numpy, accel_q, accel_windows  # noqa: E402

TOOLS = {"multiFaAcceleration": (jaccel_cli.main, accel_cli.main),
         "branchLengthsMultiFaBed": (jbranch.main, branch.main)}
SPECIES = ("hum", "chimp", "gor", "orang")


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
        except Exception as e:  # the reference's ZeroDivisionError, ...
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


def _rows(got: dict, name: str) -> list[list[str]]:
    return [ln.split("\t") for ln in got["files"][name].decode().splitlines()]


def _bits(x) -> bytes:
    return b"".join(struct.pack("<d", v) for v in np.ravel(x).tolist())


def _aln(rng, n: int, hot: tuple = (0, 0)) -> list[str]:
    """Four rows of n columns from one random row: substitutions at 4-12%
    a row (hum's at 60% in columns hot[0]:hot[1]), 2-4 gap runs of 1-8
    columns a row, a lower-case stretch in chimp's."""
    base = rng.choice(list("ACGT"), n)
    rows = []
    for k in range(4):
        r = base.copy()
        rate = np.full(n, 0.04 * (k + 1))
        if k == 0:
            rate[hot[0]:hot[1]] = 0.6
        sub = rng.random(n) < rate
        r[sub] = rng.choice(list("ACGT"), int(sub.sum()))
        for _ in range(int(rng.integers(2, 5))):
            a = int(rng.integers(1, n - 10))
            r[a:a + int(rng.integers(1, 9))] = "-"
        if k == 1:
            r[20:40] = np.char.lower(r[20:40])
        rows.append("".join(r))
    return rows


def _fa(path, rows, names=SPECIES) -> str:
    return _write(path, [x for nm, r in zip(names, rows)
                         for x in (f">{nm}", r)])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accel")
    rng = np.random.default_rng(3110)
    f = {}
    f["rows"] = _aln(rng, 320, hot=(120, 200))
    f["fa"] = _fa(tmp / "a.fa", f["rows"])
    f["short_rows"] = _aln(rng, 200)
    f["short"] = _fa(tmp / "s.fa", f["short_rows"])
    f["three"] = _fa(tmp / "three.fa", f["rows"][:3])
    f["ragged"] = _fa(tmp / "ragged.fa", f["rows"][:3] + [f["rows"][3][:-1]])
    f["space"] = _write(tmp / "space.bed", [
        "chr2\t0\t60", "chr2\t90\t200", "chr2\t230\t260", "chr9\t0\t300"])
    starts = sorted(rng.choice(np.arange(0, 230), 12, replace=False).tolist())
    regions = [f"chr2\t{s}\t{s + int(rng.integers(10, 60))}" for s in starts]
    f["regions"] = _write(tmp / "regions.bed", regions)
    # two chroms: chr3's regions sort after chr2's and go back
    f["two_chroms"] = _write(tmp / "two.bed", regions[:5] + [
        "chr3\t5\t40", "chr3\t50\t90"])
    f["off_end"] = _write(tmp / "off.bed", ["chr2\t250\t400"])
    return f


# --- multiFaAcceleration


ACCEL_CASES = {
    "mutation": ["-windowSize", "30", "-rawVelOut", "{d}/rv.bed",
                 "-rawInitialOut", "{d}/ri.bed"],
    "snp_space": ["-windowSize", "25", "-useSnpDistance", "-searchSpaceBed",
                  "{space}", "-searchSpaceProportion", "0.5"],
    "negative_cavalli": ["-windowSize", "40", "-allowNegative",
                         "-cavalliSforzaEdwardsQ", "-rawVelOut",
                         "{d}/rv.bed"],
    "zero_weight_eps": ["-windowSize", "20", "-useSnpDistance",
                        "-zeroDistanceWeightConstant", "50", "-epsilon",
                        "1e-4"],
}


@pytest.mark.parametrize("case", sorted(ACCEL_CASES))
def test_multi_fa_acceleration(files, tmp_path, case):
    """The windows are numpy's (the reference length, the end rule, the
    sliding search-space count at int(proportion * window)); the
    acceleration is velocity less initial; each column averages 1; raw
    over normalised is one constant a file; lengths >= 0 unless
    -allowNegative."""
    flags = [a.format(d="{d}", **files) for a in ACCEL_CASES[case]]
    got = _both(tmp_path, "multiFaAcceleration", lambda d: [
        "chr2", files["fa"], d + "/v.bed", d + "/a.bed", d + "/i.bed",
        *[a.replace("{d}", d) for a in flags]])
    assert got["exit"] is None
    window = int(flags[1])
    bits = threshold = None
    if case == "snp_space":
        ref_len = sum(c != "-" for c in files["rows"][0][:-1])
        bits = np.zeros(ref_len, bool)
        for s, e in ((0, 60), (90, 200), (230, 260)):
            bits[s:e] = True
        threshold = int(0.5 * window)
    v, a, i = (_rows(got, n) for n in ("v.bed", "a.bed", "i.bed"))
    assert [(int(r[1]), int(r[2])) for r in v] == accel_windows(
        files["rows"][0], window, bits, threshold or 0)
    assert all(r[0] == "chr2" for r in v)
    vel = np.array([float(r[3]) for r in v])
    ini = np.array([float(r[3]) for r in i])
    acc = np.array([float(r[3]) for r in a])
    # each column is written %.8g: 1e-7 of the three magnitudes
    tol = 1e-7 * (np.abs(acc) + np.abs(vel) + np.abs(ini)) + 1e-12
    assert (np.abs(acc - (vel - ini)) <= tol).all()
    assert abs(vel.mean() - 1) < 1e-6 and abs(ini.mean() - 1) < 1e-6
    if "rv.bed" in got["files"]:
        raw = np.array([float(r[3]) for r in _rows(got, "rv.bed")])
        ratio = raw[vel != 0] / vel[vel != 0]
        assert np.allclose(ratio, ratio[0], rtol=1e-6)
    if case != "negative_cavalli":
        assert (vel >= 0).all() and (ini >= 0).all()


@pytest.mark.parametrize("case", ["three", "ragged", "window_too_big"])
def test_multi_fa_acceleration_exits(files, tmp_path, case):
    """Three records and ragged rows exit with the reference's messages;
    a window past the reference writes no row and the means divide by
    zero."""
    fa = files["fa"] if case == "window_too_big" else files[case]
    got = _both(tmp_path, "multiFaAcceleration", lambda d: [
        "chr2", fa, d + "/v.bed", d + "/a.bed", d + "/i.bed", "-windowSize",
        "400"])
    assert got["exit"] == {
        "three": "multiFaAcceleration accepts a multiFa file with 4 records,"
                 " found 3.",
        "ragged": "Error. All records must be of the same sequence length.",
        "window_too_big": "ZeroDivisionError: float division by zero"}[case]


def test_multi_fa_acceleration_caches_by_distances(files, tmp_path,
                                                   monkeypatch):
    """The least-squares fit runs once a distinct (d, w)."""
    calls, keys = [], set()
    fit = accel.branch_lengths_alternating_least_squares
    snp = accel.four_way_snp_distances

    def counted(dist, *a):
        calls.append(1)
        return fit(dist, *a)

    def seen(*a):
        dist, end = snp(*a)
        keys.add(tuple(dist.d) + tuple(dist.w))
        return dist, end

    monkeypatch.setattr(accel, "branch_lengths_alternating_least_squares",
                        counted)
    monkeypatch.setattr(accel, "four_way_snp_distances", seen)
    accel_cli.main(["chr2", files["short"], str(tmp_path / "v"),
                    str(tmp_path / "a"), str(tmp_path / "i"), "-windowSize",
                    "20", "-useSnpDistance"])
    rows = (tmp_path / "v").read_text().count("\n")
    assert len(calls) == len(keys) < rows


def test_multi_fa_acceleration_end_writes_no_row(files, tmp_path,
                                                 monkeypatch):
    """A window whose distances reach the alignment's end writes no row
    and stops the scan (forced on both sides at the 150th window)."""
    for mod in (jaccel, accel):
        real = mod.four_way_snp_distances
        n = [0]

        def forced(*a, real=real, n=n):
            n[0] += 1
            dist, _ = real(*a)
            return dist, n[0] >= 150

        monkeypatch.setattr(mod, "four_way_snp_distances", forced)
    got = _both(tmp_path, "multiFaAcceleration", lambda d: [
        "chr2", files["fa"], d + "/v.bed", d + "/a.bed", d + "/i.bed",
        "-windowSize", "20", "-useSnpDistance"])
    assert got["exit"] is None
    assert len(_rows(got, "v.bed")) == 149


# --- branchLengthsMultiFaBed


BRANCH_CASES = {
    "snp_q": ["{regions}", "-qOutFile", "{d}/q.bed", "-useSnpDistance"],
    "mutation": ["{regions}", "-qOutFile", "{d}/q.bed"],
    "space": ["{regions}", "-searchSpaceBed", "{space}",
              "-searchSpaceProportion", "0.6", "-useSnpDistance"],
    "two_chroms": ["{two_chroms}", "-allowNegative", "-cavalliSforzaEdwardsQ"],
    "off_end": ["{off_end}"],
}


@pytest.mark.parametrize("case", sorted(BRANCH_CASES))
def test_branch_lengths_multi_fa_bed(files, tmp_path, case):
    """Every region written under the chrom argument (regions of other
    chroms too, without a search space); with one, a region kept where
    count / size reaches the proportion; the ungapped count numpy's over
    size alignment columns; a region off the alignment exits."""
    flags = [a.format(d="{d}", **files) for a in BRANCH_CASES[case]]
    got = _both(tmp_path, "branchLengthsMultiFaBed", lambda d: [
        "chr2", files["fa"], flags[0], d + "/v.bed", d + "/i.bed",
        d + "/u.bed", *[a.replace("{d}", d) for a in flags[1:]]])
    if case == "off_end":
        assert got["exit"] == ("Error: bed entry ran off the end of the "
                               "multiple alignment chromosome.")
        return
    assert got["exit"] is None
    regions = sorted((ln.split("\t")[0], int(ln.split("\t")[1]),
                      int(ln.split("\t")[2]))
                     for ln in open(flags[0]).read().splitlines())
    if case == "space":
        bits = np.zeros(400, bool)
        for s, e in ((0, 60), (90, 200), (230, 260)):
            bits[s:e] = True
        regions = [r for r in regions
                   if bits[r[1]:r[2]].sum() / (r[2] - r[1]) >= 0.6]
    u = _rows(got, "u.bed")
    assert [(int(r[1]), int(r[2])) for r in u] == [(s, e)
                                                  for _, s, e in regions]
    assert all(r[0] == "chr2" for r in u)
    mat = np.array([list(r) for r in files["rows"]])
    ungapped = (np.char.upper(mat) != "-").all(axis=0)
    cols = np.flatnonzero(mat[0] != "-")
    want = [int(ungapped[cols[s]:cols[s] + e - s].sum())
            for _, s, e in regions]
    assert [int(r[3]) for r in u] == want
    if case == "two_chroms":
        assert sum(r[0] == "chr3" for r in regions) == 2


# --- the library against the JAX's


def _records(mod, path):
    return mod.read(path)


def test_accel_public_names_defined():
    own = [n for n, v in vars(jaccel).items()
           if not n.startswith("_")
           and getattr(v, "__module__", None) == jaccel.__name__]
    assert len(own) == 10
    assert all(getattr(accel, n).__module__ == accel.__name__ for n in own)


def test_accel_columns_and_distances_equal_jax(files):
    """is_ungapped_column, both four-way distances (every start, windows
    of 20 and 45, zero constants 1000 and 3, with and without cavalli)
    and both pairwise distances, floats by their bits."""
    j, p = _records(jfasta, files["fa"]), _records(fasta, files["fa"])
    mat = np.stack([np.asarray(r.seq) for r in p])
    n = mat.shape[1]
    assert [accel.is_ungapped_column(mat, i) for i in range(n)] == [
        jaccel.is_ungapped_column(mat, i) for i in range(n)]
    for fn in ("four_way_snp_distances", "four_way_mutation_distances"):
        for start in range(0, n, 7):
            for window, zc, cav in ((20, 1000.0, False), (45, 3.0, True)):
                jd, je = getattr(jaccel, fn)(j, start, window, zc, cav)
                pd, pe = getattr(accel, fn)(p, start, window, zc, cav)
                assert pe == je
                assert _bits(pd.d) == _bits(jd.d)
                assert _bits(pd.w) == _bits(jd.w)
    for a, b in ((0, 1), (2, 3), (1, 3)):
        for start in range(0, n, 11):
            assert accel.pairwise_mutation_distance_window(
                p[a].seq, p[b].seq, start, 30) == \
                jaccel.pairwise_mutation_distance_window(
                    j[a].seq, j[b].seq, start, 30)
            end = min(n, start + 40)
            assert accel.pairwise_mutation_distance_range(
                p[a].seq, p[b].seq, start, end) == \
                jaccel.pairwise_mutation_distance_range(
                    j[a].seq, j[b].seq, start, end)
    for mod, recs in ((jaccel, j), (accel, p)):
        with pytest.raises(SystemExit, match="alnEnd must be less than"):
            mod.pairwise_mutation_distance_range(recs[0].seq, recs[1].seq,
                                                 0, n + 1)


def test_accel_mutation_distance_counts_an_indel_once():
    a = np.array([0, 1, 10, 10, 10, 2, 3, 0, 1, 2], np.int8)
    b = np.array([0, 1, 2, 3, 0, 2, 10, 10, 1, 3], np.int8)
    for mod in (jaccel, accel):
        assert mod.pairwise_mutation_distance_range(a, b, 0, 10) == 3
        # six hum bases end at column 8, before the last mismatch
        assert mod.pairwise_mutation_distance_window(a, b, 0, 6) == (
            2, False, 9)


def _dist(mod, d, zero_constant=1000.0, cavalli=False):
    d = np.asarray(d, np.float64)
    w = np.array([mod._weight(x, zero_constant, cavalli) for x in d])
    return mod.Distances(d, w)


# distance vectors: near-additive, a zero, triangle violations that drive
# each negative case of the triple fit
D_CASES = [[2, 5, 7, 5, 7, 6], [0, 3, 4, 3, 4, 2], [4, 1, 1, 1, 1, 0.5],
           [1, 9, 2, 9, 2, 1], [6, 2, 9, 3, 8, 12], [3, 3, 0, 3, 0, 3],
           [0, 0, 0, 0, 0, 0], [10, 1, 1, 9, 9, 0], [1, 1, 8, 1, 8, 9]]


@pytest.mark.parametrize("allow_negative", [False, True])
@pytest.mark.parametrize("cavalli", [False, True])
def test_accel_least_squares_equal_jax(allow_negative, cavalli):
    """calculate_q (its doubled chimp_hca term) and the alternating least
    squares, floats by their bits; chip_smoke's plain fit and Q, which
    gate the card's run, equal to them."""
    rng = np.random.default_rng(3111)
    cases = D_CASES + [list(rng.uniform(0, 20, 6)) for _ in range(12)]
    for d in cases:
        jd, pd = _dist(jaccel, d, 7.0, cavalli), _dist(accel, d, 7.0,
                                                       cavalli)
        assert _bits(pd.w) == _bits(jd.w)
        jb = jaccel.branch_lengths_alternating_least_squares(
            jd, allow_negative, 7.0, 1e-8, cavalli)
        pb = accel.branch_lengths_alternating_least_squares(
            pd, allow_negative, 7.0, 1e-8, cavalli)
        lens = [pb.hum_hca, pb.chimp_hca, pb.hca_hga, pb.hga_gor,
                pb.hga_orang]
        assert _bits(lens) == _bits([jb.hum_hca, jb.chimp_hca, jb.hca_hga,
                                     jb.hga_gor, jb.hga_orang])
        if not allow_negative:
            assert min(lens) >= 0
        q = accel.calculate_q(pd, pb)
        assert _bits(q) == _bits(jaccel.calculate_q(jd, jb))
        assert _bits(accel_q(pd.d, pd.w, lens)) == _bits(q)
        if not allow_negative and not cavalli:
            assert _bits(accel_fit_numpy(pd.d, pd.w, 7.0)) == _bits(lens)
        h, c, hh, g, o = lens
        dd, w = pd.d, pd.w
        want = (w[0] * (dd[0] - 2 * c) ** 2
                + w[1] * (dd[1] - (h + hh + g)) ** 2
                + w[2] * (dd[2] - (h + hh + o)) ** 2
                + w[3] * (dd[3] - (c + hh + g)) ** 2
                + w[4] * (dd[4] - (c + hh + o)) ** 2
                + w[5] * (dd[5] - (g + o)) ** 2)
        assert q == pytest.approx(want, rel=1e-12, abs=1e-12)
        assert q <= accel.calculate_q(pd, accel.BranchLengths()) + 1e-12


def test_accel_weights_zero_and_cavalli():
    for mod in (jaccel, accel):
        assert list(_dist(mod, [0, 2, 4, 0, 1, 3], 55.0).w) == [
            55.0, 0.25, 0.0625, 55.0, 1.0, 1 / 9]
        assert list(_dist(mod, [0, 2, 4, 0, 1, 3], 55.0, True).w) == [1.0] * 6


def test_accel_triple_fit_left_and_right_differ():
    """_optimize_triple's left and right forms update the two other
    branches in opposite orders in two negative cases: equal to the
    JAX's in both forms, and apart where the order matters."""
    rng = np.random.default_rng(3112)
    differ = 0
    for _ in range(400):
        d = rng.uniform(0, 10, 3)
        w = rng.uniform(0.1, 2, 3)
        for right in (False, True):
            got = accel._optimize_triple(*d, *w, False, right)
            assert _bits(got) == _bits(jaccel._optimize_triple(*d, *w, False,
                                                               right))
        differ += (accel._optimize_triple(*d, *w, False, False)
                   != accel._optimize_triple(*d, *w, False, True))
    assert differ > 0


def test_accel_least_squares_exits_after_100000_rounds():
    """A negative epsilon never stops the loop: 100,000 rounds, then the
    reference's message."""
    for mod in (jaccel, accel):
        with pytest.raises(SystemExit, match="Failed to converge on a tree "
                                             "with these distances."):
            mod.branch_lengths_alternating_least_squares(
                _dist(mod, [2, 5, 7, 5, 7, 6]), False, 1000.0, -1.0, False)


def test_accel_search_space_bits_equal_jax(files):
    for length in (100, 320):
        j = jaccel.make_bit_array_from_search_space(files["space"], length,
                                                    "chr2")
        p = accel.make_bit_array_from_search_space(files["space"], length,
                                                   "chr2")
        assert p.dtype == j.dtype == np.bool_
        assert np.array_equal(p, j) and p.sum() > 0
