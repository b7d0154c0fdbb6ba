"""The port's variant caller (gonomics_tpu_torch/cli/call_variants.py) on
the CPU against the JAX callVariants: byte-identical VCF text on the same
inputs, built here from a numpy seed (tests/test_torch_card.py
``_variant_inputs``: two chromosomes of 12 and 6 kb, a tumour/normal pair
of coordinate-sorted SAM files with planted SNVs and indels, BAM copies
written by the JAX package's bam_writer): experimental alone and with the
normal, SAM and BAM, default and loosened thresholds, without a mesh and
on meshes of repeated CPU devices; the CLI against the library; the
package imports no JAX; the entry points that take a device want the
card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gonomics_tpu.cli import call_variants as jcv
from gonomics_tpu.io import bam_writer
from gonomics_tpu.io import sam as jsam
from gonomics_tpu.parallel import make_mesh as jax_make_mesh
from gonomics_tpu_torch import motif, parallel, popgen
from gonomics_tpu_torch.cli import call_variants as tcv
from gonomics_tpu_torch.io import vcf

from test_torch_card import _variant_inputs

LOOSE = {"max_p": 1.1, "min_af": 0, "min_coverage": 0}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cv"))
    ref, exp, norm, variants = _variant_inputs(tmp, seed=7)
    files = {"tmp": tmp, "ref": ref, "variants": variants,
             "sam": (exp, norm), "bam": ()}
    bams = []
    for path in (exp, norm):
        header, records = jsam.read(path)
        bam = path[:-4] + ".bam"
        bam_writer.write_bam(bam, header, records)
        bams.append(bam)
    files["bam"] = tuple(bams)
    return files


_jax_cache: dict = {}


def _jax_vcf(inputs, fmt: str, with_norm: bool, loose: bool) -> bytes:
    key = (fmt, with_norm, loose)
    if key not in _jax_cache:
        exp, norm = inputs[fmt]
        out = os.path.join(inputs["tmp"], "jax_{}_{}_{}.vcf".format(*key))
        jcv.call_variants([exp], [norm] if with_norm else [], inputs["ref"],
                          out, **(LOOSE if loose else {}))
        with open(out, "rb") as f:
            _jax_cache[key] = f.read()
    return _jax_cache[key]


def _port_vcf(inputs, fmt, with_norm, loose, mesh=None) -> bytes:
    exp, norm = inputs[fmt]
    out = os.path.join(inputs["tmp"], "port.vcf")
    tcv.call_variants([exp], [norm] if with_norm else [], inputs["ref"], out,
                      mesh=mesh, **(LOOSE if loose else {}))
    with open(out, "rb") as f:
        return f.read()


def _mesh(shape):
    if shape is None:
        return None
    d, s = shape
    return parallel.make_mesh(devices=["cpu"] * (d * s), data=d, seq=s)


@pytest.mark.parametrize("mesh", [None, (1, 1), (2, 1), (4, 2)])
@pytest.mark.parametrize("loose", [False, True], ids=["default", "loose"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("with_norm", [False, True], ids=["exp", "exp_norm"])
def test_vcf_matches_jax(inputs, with_norm, fmt, loose, mesh):
    want = _jax_vcf(inputs, fmt, with_norm, loose)
    got = _port_vcf(inputs, fmt, with_norm, loose, _mesh(mesh))
    assert got == want
    body = [ln for ln in want.decode().splitlines() if ln[:1] != "#"]
    # without the normal, default thresholds call nothing here: the
    # experimental sample is its own background
    assert len(body) >= (1000 if loose else 10 if with_norm else 0)


def test_jax_mesh_equals_port_mesh(inputs):
    """The JAX caller on its mesh of 8 virtual CPU devices (4 x 2) and the
    port on 4 x 2 repeated CPU devices write the same VCF."""
    exp, norm = inputs["sam"]
    out = os.path.join(inputs["tmp"], "jax_mesh.vcf")
    jcv.call_variants([exp], [norm], inputs["ref"], out,
                      mesh=jax_make_mesh(8, data=4, seq=2))
    with open(out, "rb") as f:
        want = f.read()
    assert _port_vcf(inputs, "sam", True, False, _mesh((4, 2))) == want


def test_planted_variants_called(inputs):
    """With the normal, at default thresholds, most planted SNVs are
    called, each with its alt among the record's alts."""
    text = _port_vcf(inputs, "sam", True, False).decode()
    rows = [ln.split("\t") for ln in text.splitlines() if ln[:1] != "#"]
    called = {(r[0], int(r[1])): r for r in rows}
    snvs = [(c, p) for c, v in inputs["variants"].items()
            for p, (kind, _) in v.items() if kind == "snv"]
    hit = [(c, p) for c, p in snvs if (c, p + 1) in called]
    assert len(hit) >= 0.8 * len(snvs)
    codes = "ACGT"
    for c, p in hit:
        alt = codes[inputs["variants"][c][p][1]]
        assert alt in called[(c, p + 1)][4].split(","), (c, p)


@pytest.mark.parametrize("argv", [
    [], ["--mesh", "--device", "cpu"],
    ["-p", "1.1", "-minAF", "0", "-minCoverage", "0", "--mesh", "--device",
     "cpu"]], ids=["host", "mesh", "loose_mesh"])
def test_cli_matches_library(inputs, argv, tmp_path):
    """callVariants' CLI writes the library call's bytes; with --profile
    it also writes its torch.profiler trace."""
    exp, norm = inputs["sam"]
    out = str(tmp_path / "cli.vcf")
    prof = str(tmp_path / "prof")
    tcv.main(["-i", exp, "-n", norm, "-r", inputs["ref"], "-o", out,
              "--profile", prof, *argv])
    loose = "-p" in argv
    want = _jax_vcf(inputs, "sam", True, loose)
    with open(out, "rb") as f:
        assert f.read() == want
    assert os.path.getsize(os.path.join(prof, "call_variants.pt.trace.json"))


def test_cli_to_stdout(inputs, capsys):
    exp, _ = inputs["sam"]
    tcv.main(["-i", exp, "-r", inputs["ref"]])
    assert capsys.readouterr().out.encode() == _jax_vcf(inputs, "sam", False,
                                                        False)


def test_cli_needs_an_experimental_sample(inputs):
    with pytest.raises(SystemExit, match="at least 1 experimental"):
        tcv.main(["-r", inputs["ref"]])


def test_vcf_records_match_jax():
    """io.vcf's Sample and Vcf text equals the JAX's, samples with and
    without genotypes, phased and not, float and integer quals."""
    from gonomics_tpu.io import vcf as jvcf

    cases = [dict(alleles=[0, 1], phase=[False, False],
                  format_data=["", "12", "3,9", "1e-05"]),
             dict(alleles=None, format_data=["", "4"]),
             dict(alleles=[1, 1], phase=[True, True], format_data=["x"]),
             dict(format_data=None)]
    for qual in (0.0, 13.5, 30.0):
        kw = dict(chrom="chr2", pos=77, ref="AC", alt=["A", "ACT"],
                  qual=qual, filter="NO_NORMAL", info=".",
                  format=["GT", "DP", "AD", "PV"])
        got = vcf.Vcf(**kw, samples=[vcf.Sample(**c) for c in cases])
        want = jvcf.Vcf(**kw, samples=[jvcf.Sample(**c) for c in cases])
        assert got.to_string() == want.to_string()
    assert vcf.Vcf(chrom="c", pos=1).to_string() == jvcf.Vcf(
        chrom="c", pos=1).to_string()


def test_new_modules_import_no_jax():
    """The slice's modules import neither JAX nor the JAX package."""
    code = ("import sys, gonomics_tpu_torch.numbers, gonomics_tpu_torch.io.fai,"
            " gonomics_tpu_torch.io.sam, gonomics_tpu_torch.io.vcf,"
            " gonomics_tpu_torch.pileup, gonomics_tpu_torch.parallel,"
            " gonomics_tpu_torch.cli.call_variants, gonomics_tpu_torch.motif,"
            " gonomics_tpu_torch.popgen\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gonomics_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_entry_points_want_the_card(inputs, monkeypatch):
    """Without a card: the motif scan and the popgen functions raise for
    device=None and "cuda", and callVariants --mesh raises (its mesh is
    every CUDA device); none carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    pm = motif.PositionMatrix(mat=np.ones((4, 3)))
    seq = np.zeros(10, np.int8)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            motif.scan_scores_device(pm, seq, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            popgen.afs_sample_density_grid([20], [5], [2.0], device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            popgen.wright_fisher_sim(100, 5, device=device)
    exp, _ = inputs["sam"]
    out = os.path.join(inputs["tmp"], "nocard.vcf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcv.main(["-i", exp, "-r", inputs["ref"], "-o", out, "--mesh"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcv.make_mesh_for("cuda")
