"""The port's ``wigTools`` (gonomics_tpu_torch/cli/wig_tools.py: its
``filter``, ``peaks``, ``math``, ``stats`` and ``toTrainingSet``
subcommands, with ``smooth`` and ``pearson``) on the CPU against the JAX
tool: the bytes of every file it writes and the message of every exit,
on fixed-step wigs that a numpy seed builds here over chr1, chr2 and
chr10 (whose string order differs from their number order): runs of the
missing value 0 at chromosome starts and ends, negative values, peaks
above 20, an entry with a step of 2, and a genome with lower-case bases.
Each quirk of the reference that the port keeps is pinned by a case
here.
"""

import os

import numpy as np
import pytest

from gonomics_tpu.cli import wig_tools as jwig_tools
from gonomics_tpu_torch.cli import wig_tools

SIZES = [("chr1", 700), ("chr2", 300), ("chr10", 240)]


def _both(tmp_path, argv) -> dict:
    """Runs the JAX wigTools and the port's with argv(d), d a directory of
    each side's own, and holds their exits and the files they wrote
    equal; returns the port's {name: bytes}, its exit under "exit": the
    SystemExit's message, or the type and message of any other
    exception."""
    seen = {}
    for side, main in (("jax", jwig_tools.main), ("port", wig_tools.main)):
        d = tmp_path / side
        d.mkdir()
        out = {}
        try:
            main(argv(str(d)))
        except SystemExit as e:
            out["exit"] = str(e)
        except Exception as e:  # the JAX tool's ZeroDivisionError, ...
            out["exit"] = f"{type(e).__name__}: {e}"
        for n in sorted(os.listdir(d)):
            with open(os.path.join(d, n), "rb") as f:
                out[n] = f.read()
        seen[side] = out
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _values(rng, n: int, positive: bool = False) -> list[float]:
    v = np.round(rng.normal(8, 9, n), 2)
    if positive:
        v = np.abs(v) + 0.5
        v[rng.random(n) < 0.1] = -10  # toTrainingSet's missing value
    else:
        v[rng.random(n) < 0.15] = 0
        v[:3] = v[-4:] = 0
        peaks = rng.integers(0, n - 10, 4)
        for p in peaks:
            v[p:p + 6] = np.round(rng.uniform(20, 40, 6), 2)
    return v.tolist()


def _wig(path, rng, positive=False) -> str:
    lines = []
    for chrom, n in SIZES:
        if chrom == "chr2":  # a step of 2, then a gap, then step 1
            lines.append(f"fixedStep chrom={chrom} start=1 step=2")
            lines += [str(x) for x in _values(rng, 100, positive)]
            lines.append(f"fixedStep chrom={chrom} start=221 step=1")
            lines += [str(x) for x in _values(rng, 80, positive)]
        else:
            lines.append(f"fixedStep chrom={chrom} start=1 step=1")
            lines += [str(x) for x in _values(rng, n, positive)]
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in lines)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wig_tools")
    rng = np.random.default_rng(2613)
    f = {"a": _wig(d / "a.wig", rng), "b": _wig(d / "b.wig", rng),
         "pos": _wig(d / "pos.wig", rng, positive=True)}
    f["sizes"] = str(d / "t.sizes")
    with open(f["sizes"], "w") as fh:
        fh.writelines(f"{c}\t{n}\n" for c, n in SIZES)
    f["genome"] = str(d / "g.fa")
    with open(f["genome"], "w") as fh:
        for c, n in SIZES:
            fh.write(f">{c}\n" + "".join(rng.choice(list("ACGTacgN"), n))
                     + "\n")
    f["genome_chr1"] = str(d / "g1.fa")
    with open(f["genome_chr1"], "w") as fh:
        fh.write(">chr1\n" + "A" * 700 + "\n")
    beds = {"mask": "chr1\t10\t50\nchr10\t200\t240\nchr2\t0\t5\n",
            "mask_past": "chr2\t250\t301\n",
            "nogap": "chr1\t0\t700\nchr2\t100\t300\nchr10\t5\t100\n",
            "nogap_bad": "chr1\t0\t10\nchrX\t0\t10\n"}
    for k, text in beds.items():
        f[k] = str(d / f"{k}.bed")
        with open(f[k], "w") as fh:
            fh.write(text)
    return f


@pytest.mark.parametrize("args", [[], ["-chrom", "chr2"],
                                  ["-defaultValue", "-1"]])
def test_wig_filter(files, tmp_path, args):
    got = _both(tmp_path, lambda o: ["filter", files["a"], files["sizes"],
                                     os.path.join(o, "out.wig"), *args])
    assert "exit" not in got
    if args[:1] == ["-chrom"]:
        assert all(ln.startswith(b"fixedStep chrom=chr2")
                   for ln in got["out.wig"].splitlines()
                   if ln.startswith(b"fixed"))


@pytest.mark.parametrize("args", [[], ["-threshold", "5", "-findMinima"],
                                  ["-threshold", "30", "-missingValue",
                                   "1"]])
def test_wig_peaks(files, tmp_path, args):
    """Chroms in sorted order (chr1, chr10, chr2), scores truncated."""
    got = _both(tmp_path, lambda o: ["peaks", files["a"], files["sizes"],
                                     os.path.join(o, "out.bed"), *args])
    rows = [ln.split(b"\t") for ln in got["out.bed"].splitlines()]
    assert rows
    chroms = [r[0] for r in rows]
    assert chroms == sorted(chroms)


@pytest.mark.parametrize("args", [
    ["-scalarMultiply", "2"], ["-scalarDivide", "4"],
    ["-scalarMultiply", "2", "-scalarDivide", "4"],
    ["-elementWiseAdd", "b"], ["-elementWiseMax", "b"],
    ["-elementWiseSubtract", "b"], ["-movingAverageSmoothing", "5"],
    ["-missing", "-1", "-movingAverageSmoothing", "3"],
    ["-absoluteError", "b"], ["-absolutePercentError", "b"],
    ["-minValue", "5"], ["-maxValue", "10"], ["-missingBed"],
    ["-bedMask", "mask"]])
def test_wig_math(files, tmp_path, args):
    """One operation a run, in the reference's elif order: -scalarDivide
    is not counted among the operations, so with -scalarMultiply it is
    ignored; smoothing leaves out the last window and writes the missing
    value where a window holds one; -missingBed writes the current region
    again at a chrom change."""
    args = [files.get(a, a) for a in args]
    got = _both(tmp_path, lambda o: ["math", files["a"], files["sizes"],
                                     os.path.join(o, "out"), *args])
    assert "exit" not in got and got["out"]


@pytest.mark.parametrize("args", [
    ["-pearson", "b", "-sampleFrequency", "1"],
    ["-pearson", "b", "-sampleFrequency", "0.3", "-setSeed", "5"],
    ["-pearson", "b", "-sampleFrequency", "0.05"],
    ["-pearson", "b"]])
def test_wig_math_pearson(files, tmp_path, args):
    """numpy's global generator, seeded with -setSeed & 0x7FFFFFFF, draws
    the sample wherever -sampleFrequency < 1 (its default 0.001 too, which
    keeps next to nothing here)."""
    args = [files.get(a, a) for a in args]
    got = _both(tmp_path, lambda o: ["math", files["a"], files["sizes"],
                                     os.path.join(o, "out"), *args])
    if "exit" not in got:
        assert got["out"].startswith(b"PCC:\t")
    if args[-1] == "1":
        assert "exit" not in got


@pytest.mark.parametrize("args,want", [
    (["-scalarDivide", "0"], "cannot divide wig values by zero"),
    (["-minValue", "5", "-maxValue", "10"],
     "wigTools math can perform only one mathematical operation at a time."),
    (["-bedMask", "mask_past"], "position exceeds length of chr2"),
    (["-pearson", "b", "-sampleFrequency", "1.5"],
     "samplingFrequency must be between 0 and 1")])
def test_wig_math_exits(files, tmp_path, args, want):
    args = [files.get(a, a) for a in args]
    got = _both(tmp_path, lambda o: ["math", files["a"], files["sizes"],
                                     os.path.join(o, "out"), *args])
    assert got["exit"] == want


@pytest.mark.parametrize("args", [[], ["-missingDataValue", "0"]])
def test_wig_stats(files, tmp_path, args):
    """Values truncated toward zero; a negative one counts from the end of
    the histogram."""
    got = _both(tmp_path, lambda o: ["stats", files["a"], files["sizes"],
                                     files["nogap"],
                                     os.path.join(o, "out.txt"), *args])
    assert got["out.txt"].startswith(b"coverage\tcount\n0\t")


def test_wig_stats_missing_chrom_exits(files, tmp_path):
    got = _both(tmp_path, lambda o: ["stats", files["a"], files["sizes"],
                                     files["nogap_bad"],
                                     os.path.join(o, "out.txt")])
    assert got["exit"] == "chrom chrX not in reference genome"


@pytest.mark.parametrize("src,args", [
    ("pos", ["-windowSize", "50", "-stride", "30", "-setSeed", "3"]),
    ("pos", ["-windowSize", "40", "-stride", "25", "-setSeed", "4",
             "-logTransform", "-includeRevComp", "-noHeader"]),
    ("a", ["-windowSize", "60", "-stride", "60", "-setSeed", "2",
           "-missing", "0", "-validationProp", "0.3", "-testingProp",
           "0.3"]),
    ("pos", ["-setSeed", "1"])])
def test_wig_to_training_set(files, tmp_path, src, args):
    """range(0, len - window, stride) over each entry (its last full
    window left out), windows at the missing value skipped, shards drawn
    from np.random.default_rng seeded with -setSeed, values as Go's %g."""
    got = _both(tmp_path, lambda o: [
        "toTrainingSet", files[src], files["genome"],
        *[os.path.join(o, n) for n in ("train", "validate", "test")], *args])
    assert "exit" not in got
    lines = sum(got[n].count(b"\n") for n in ("train", "validate", "test"))
    assert lines > (0 if "-noHeader" in args else 3)


@pytest.mark.parametrize("genome,args,want", [
    ("genome", ["-validationProp", "0.6", "-testingProp", "0.5"],
     "pValidation + pTesting should sum to less than one."),
    ("genome_chr1", ["-setSeed", "1"],
     "wig chromosome chr2 not in genome")])
def test_wig_to_training_set_exits(files, tmp_path, genome, args, want):
    got = _both(tmp_path, lambda o: [
        "toTrainingSet", files["pos"], files[genome],
        *[os.path.join(o, n) for n in ("train", "validate", "test")], *args])
    assert got["exit"] == want


@pytest.mark.parametrize("argv,want", [
    ([], "usage: wigTools <peaks|filter|math|stats|toTrainingSet> ..."),
    (["bogus"], "unrecognized subcommand: bogus")])
def test_wig_tools_exits(tmp_path, argv, want):
    assert _both(tmp_path, lambda o: argv)["exit"] == want


def test_smooth_and_pearson_equal_jax(files):
    """smooth's values and pearson's r on the same records, float64 bit
    for bit, after the same global seed."""
    from gonomics_tpu.io import wig as jwig
    from gonomics_tpu_torch.io import wig

    a_j = jwig.read(files["a"], files["sizes"], 0.0)
    b_j = jwig.read(files["b"], files["sizes"], 0.0)
    a_t = wig.read(files["a"], files["sizes"], 0.0)
    b_t = wig.read(files["b"], files["sizes"], 0.0)
    for window in (2, 5, 699):
        for key in a_t:
            assert np.array_equal(
                wig_tools.smooth(a_t[key], window, 0.0).values,
                jwig_tools.smooth(a_j[key], window, 0.0).values)
    for freq in (1.0, 0.5):
        np.random.seed(11)
        want = jwig_tools.pearson(a_j, b_j, 0.0, freq)
        np.random.seed(11)
        assert wig_tools.pearson(a_t, b_t, 0.0, freq) == want
