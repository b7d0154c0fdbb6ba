"""The port's lastZWriter, formatIdeogram and slurmCheck
(gonomics_tpu_torch/cli/last_z_writer.py, format_ideogram.py,
slurm_check.py) with ``lastz_writer.py``, on the CPU against the JAX
package: the job lines and the directory tree lastZWriter makes, the
ideogram points and slurmCheck's report, byte for byte, and every exit
by type and message. Each side runs in a directory of its own with the
same relative paths, so that the job lines can be compared as bytes.
"""

import dataclasses
import os

import numpy as np
import pytest

from gonomics_tpu import lastz_writer as jlz
from gonomics_tpu.cli import main as jmain
from gonomics_tpu.cli import slurm_check as jslurm
from gonomics_tpu_torch import lastz_writer as lz
from gonomics_tpu_torch.cli import main as tmain
from gonomics_tpu_torch.cli import slurm_check as tslurm


def _outcome(fn, *args, **kw):
    """fn's value, or its exception's type and message."""
    try:
        return "ok", fn(*args, **kw)
    except (SystemExit, ValueError, IndexError) as e:
        return type(e).__name__, str(e)


def _tree(d):
    """The directories and {file: bytes} under d, by relative path."""
    dirs, files = [], {}
    for root, names, fnames in os.walk(d):
        dirs += sorted(os.path.relpath(os.path.join(root, n), d)
                       for n in names)
        for n in fnames:
            with open(os.path.join(root, n), "rb") as fh:
                files[os.path.relpath(os.path.join(root, n), d)] = fh.read()
    return sorted(dirs), files


def layout(d, dists=None, species=("hg", "pt", "mm"), refs=("hg", "mm"),
           empty=()):
    """A pairwise/ directory under d: hg.byChrom (chr1, chr2), pt.byChrom
    (chr1, chr2, chrUn and a file that is not .fa), mm.byChrom (c1), the
    assemblies in ``empty`` with no .fa file; a species list, a ref list
    and an allDists file (close, far, a number and default by default)."""
    rng = np.random.default_rng(3603)
    contigs = {"hg": ["chr1", "chr2"], "pt": ["chrUn", "chr1", "chr2"],
               "mm": ["c1"]}
    for a, names in contigs.items():
        os.makedirs(os.path.join(d, "pairwise", f"{a}.byChrom"))
        for n in ([] if a in empty else names):
            seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30)])
            with open(os.path.join(d, "pairwise", f"{a}.byChrom",
                                   n + ".fa"), "w") as fh:
                fh.write(f">{n}\n{seq}\n")
    with open(os.path.join(d, "pairwise", "pt.byChrom", "notes.txt"),
              "w") as fh:
        fh.write("not a fasta\n")
    if dists is None:
        dists = ["hg\tpt\tclose", "mm\thg\t0.85", "pt\tmm\tdefault",
                 "# a comment", "hg\tmm\t0.2"]
    for name, rows in (("species.txt", species), ("refs.txt", refs),
                       ("dists.txt", dists)):
        with open(os.path.join(d, name), "w") as fh:
            fh.writelines(r + "\n" for r in rows)


def _lz_both(tmp_path, monkeypatch, flags, **kw):
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir()
        layout(str(d), **kw)
        monkeypatch.chdir(d)
        res = _outcome(mod.main, [
            "lastZWriter", *flags, "lastz", "pairwise", "species.txt",
            "refs.txt", "dists.txt", "jobs.txt"])
        out[side] = (res[0], res[1] if res[0] != "ok" else None,
                     _tree(str(d)))
    return out


LZ_CASES = {
    "built_matrices": ["-m", "false", "-mPath", "mats"],
    "built_matrices_upper": ["-m", "FALSE", "-mPath", "mats"],
    "hard_coded_matrices": ["-m", "true"],
    "zero_is_true": ["-m", "0", "-mPath", "mats"],
    "default_m": [],
    "target_modifier": ["-m", "false", "-mPath", "m2", "-targetModifier",
                        "[unmask]"],
    "simple": ["-simple", "-parameters", "M=0"],
    "simple_no_parameters": ["-simple", "-targetModifier", "[multiple]"],
}


@pytest.mark.parametrize("case", list(LZ_CASES))
def test_last_z_writer_equal_jax(tmp_path, monkeypatch, case):
    """lastZWriter through each umbrella writes the same job lines, the
    same output directories and the same matrices."""
    out = _lz_both(tmp_path, monkeypatch, LZ_CASES[case])
    assert out["port"] == out["jax"]
    assert out["jax"][0] == "ok"
    dirs, files = out["jax"][2]
    jobs = files["jobs.txt"].decode().splitlines()
    assert len(jobs) == 2 * 3 + 2 * 1 + 1 * 2 + 1 * 3
    assert ("mats/default.mat" in files) == (case in (
        "built_matrices", "built_matrices_upper"))
    if case == "hard_coded_matrices":
        assert "--scores=/hpc/group/vertgenlab/alignmentSupportFiles/" in \
            jobs[0]


LZ_EXITS = {
    "no_by_chrom": dict(species=("hg", "pt", "rn")),
    "no_parameters": dict(dists=["hg\tpt\tclose"]),
    "no_lines": dict(empty=("mm",)),
}


@pytest.mark.parametrize("case", list(LZ_EXITS))
@pytest.mark.parametrize("simple", [False, True])
def test_last_z_writer_exits_equal_jax(tmp_path, monkeypatch, case, simple):
    """A species with no .byChrom directory, a pair missing from allDists
    (default mode) and an assembly with no contigs exit alike, leaving
    the same tree."""
    flags = ["-simple"] if simple else ["-m", "false", "-mPath", "mats"]
    out = _lz_both(tmp_path, monkeypatch, flags, **LZ_EXITS[case])
    assert out["port"] == out["jax"]
    if case == "no_parameters" and simple:
        assert out["jax"][0] == "ok"
    else:
        assert out["jax"][0] == "SystemExit"


@pytest.mark.parametrize("dist", ["close", "far", "default", "0.2", "0.7",
                                  "0.2000001", "0.45", "-1", "1e-3"])
@pytest.mark.parametrize("m", [True, False])
def test_find_parameters_equal_jax(tmp_path, dist, m):
    """find_parameters by category and at the numeric edges, either way
    round in the file, with the matrix path hard-coded or built."""
    path = tmp_path / "d.txt"
    path.write_text(f"a\tb\t{dist}\nc\td\tfar\n")
    for ref, spec in (("a", "b"), ("b", "a"), ("a", "c")):
        assert lz.find_parameters(ref, spec, str(path), m, "mp") == \
            jlz.find_parameters(ref, spec, str(path), m, "mp")


def test_build_matrices_equal_jax(tmp_path):
    """The three matrices' bytes."""
    lz.build_matrices(str(tmp_path / "port"))
    jlz.build_matrices(str(tmp_path / "jax"))
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    assert len(_tree(str(tmp_path / "jax"))[1]) == 3


# --- formatIdeogram ---

def _ideo_bed(path, scores=True, seed=3604, n=40):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        fh.write("# a header\n")
        for i in range(n):
            s = int(rng.integers(0, 5000))
            e = s + int(rng.integers(1, 400))
            extra = f"\tr{i}\t{rng.integers(0, 1000)}" if scores else ""
            fh.write(f"chr{1 + i % 3}\t{s}\t{e}{extra}\n")
    return str(path)


@pytest.mark.parametrize("scores,flags", [(True, []), (True, ["--noScore"]),
                                          (False, ["--noScore"]),
                                          (False, [])])
def test_format_ideogram_equal_jax(tmp_path, scores, flags):
    """formatIdeogram's points, with and without --noScore; a bed with no
    score column raises alike without it."""
    bed = _ideo_bed(tmp_path / "in.bed", scores)
    out = {}
    for side, mod in (("jax", jmain), ("port", tmain)):
        o = tmp_path / f"{side}.txt"
        res = _outcome(mod.main, ["formatIdeogram", *flags, bed, str(o)])
        out[side] = (res[0], res[1] if res[0] != "ok" else None,
                     o.read_bytes() if o.exists() else None)
    assert out["port"] == out["jax"]
    if scores or flags:
        assert out["jax"][2].count(b"\n") == 120
    else:
        assert out["jax"][0] == "IndexError"


# --- slurmCheck ---

def _fancy(path, seed, n=5):
    rng = np.random.default_rng(seed)
    kinds = ["exists", "exists+", "line", "line+"]
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"sbatch -p common --mem={rng.integers(1, 99)}G "
                     f"run{i}.sh {{check {i} {kinds[rng.integers(4)]} "
                     f"out/{i}.txt extra}} --after {rng.integers(9)}\n")
    return str(path)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_slurm_check_equal_jax(tmp_path, capsys, seed):
    """slurmCheck prints the same report of the first line, and its
    parser gives the same records of every line."""
    path = _fancy(tmp_path / "jobs.txt", seed)
    printed = []
    for mod in (jmain, tmain):
        mod.main(["slurmCheck", path])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].startswith("begin: sbatch -p common")
    assert [dataclasses.asdict(r) for r in tslurm.parse_the_input(path)] == \
        [dataclasses.asdict(r) for r in jslurm.parse_the_input(path)]


@pytest.mark.parametrize("text", ["a {b c d e} f\n\nlater {x y z w}\n",
                                  "no braces at all\n",
                                  "short {a b} tail\n"])
def test_slurm_check_exits_equal_jax(tmp_path, capsys, text):
    """An empty line, a line without a check block and a block of too few
    fields fail alike."""
    path = tmp_path / "jobs.txt"
    path.write_text(text)
    out = []
    for mod in (jmain, tmain):
        out.append((_outcome(mod.main, ["slurmCheck", str(path)])[0],
                    capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[0][0] != "ok"
