"""The port's globalAlignment and cigarToBed CLIs (--device cpu) against
the JAX package's tools with `backend="interpret"`: byte-equal stdout,
-faOut and beds, on FASTA files written here."""

import io

import numpy as np
import pytest

from gonomics_tpu import dna
from gonomics_tpu.cli import cigar_to_bed as jax_c2b
from gonomics_tpu.cli import global_alignment as jax_ga
from gonomics_tpu_torch.cli import cigar_to_bed as port_c2b
from gonomics_tpu_torch.cli import global_alignment as port_ga


def _write_fa(path, name: str, seq: str, width: int = 50) -> str:
    with open(path, "w") as f:
        f.write(f">{name}\n")
        f.writelines(seq[i:i + width] + "\n" for i in range(0, len(seq), width))
    return str(path)


def _pair(kind: str) -> tuple[str, str]:
    """chelsea/eric (globalAlignment's own test data, written inline), or
    a seeded related pair: SNPs, lowercase bases, an N, a 4 bp deletion
    and a 6 bp insertion."""
    if kind == "chelsea_eric":
        return "TTGTTATTC", "TTGTTC"
    rng = np.random.default_rng(len(kind))
    a = rng.integers(0, 4, 56).astype(np.int8)
    b = a.copy()
    b[rng.random(56) < 0.06] = rng.integers(0, 4)
    b = np.concatenate([b[:12], b[16:40], rng.integers(0, 4, 6).astype(np.int8),
                        b[40:]])
    b[20] = dna.N
    s_a, s_b = dna.to_string(a), dna.to_string(b)
    if kind == "lowercase":
        s_a = s_a[:30] + s_a[30:].lower()
    return s_a, s_b


@pytest.mark.parametrize("kind", ["chelsea_eric", "related"])
def test_global_alignment_byte_equal(tmp_path, kind):
    s_a, s_b = _pair(kind)
    fa_a = _write_fa(tmp_path / "a.fa", "chelsea", s_a)
    fa_b = _write_fa(tmp_path / "b.fa", "eric", s_b)
    got_out, want_out = io.StringIO(), io.StringIO()
    port_ga.global_alignment(fa_a, fa_b, str(tmp_path / "port.fa"),
                             device="cpu", out=got_out)
    jax_ga.global_alignment(fa_a, fa_b, str(tmp_path / "jax.fa"),
                            backend="interpret", out=want_out)
    assert got_out.getvalue() == want_out.getvalue()
    got_fa = (tmp_path / "port.fa").read_bytes()
    assert got_fa == (tmp_path / "jax.fa").read_bytes()
    if kind == "chelsea_eric":
        lines = got_out.getvalue().split("\n")
        assert lines[1:3] == ["TTGTTATTC", "TTG---TTC"]
        assert got_fa == b">chelsea\nTTGTTATTC\n>eric\nTTG---TTC\n"


def test_global_alignment_refuses_lowercase(tmp_path):
    """globalAlignment does not upper-case its input, so lowercase codes
    (5-9) are refused by both tools, as gonomics panics on them."""
    s_a, s_b = _pair("lowercase")
    fa_a = _write_fa(tmp_path / "a.fa", "a", s_a)
    fa_b = _write_fa(tmp_path / "b.fa", "b", s_b)
    with pytest.raises(ValueError, match="non-ACGTN"):
        port_ga.global_alignment(fa_a, fa_b, device="cpu", out=io.StringIO())
    with pytest.raises(ValueError, match="non-ACGTN"):
        jax_ga.global_alignment(fa_a, fa_b, backend="interpret",
                                out=io.StringIO())


@pytest.mark.parametrize("kind", ["chelsea_eric", "related", "lowercase"])
def test_cigar_to_bed_byte_equal(tmp_path, kind):
    s_a, s_b = _pair(kind)
    fa_a = _write_fa(tmp_path / "a.fa", "target", s_a)
    fa_b = _write_fa(tmp_path / "b.fa", "query", s_b)
    outs = {}
    for who, fn, where in (("port", port_c2b.cigar_to_bed, {"device": "cpu"}),
                           ("jax", jax_c2b.cigar_to_bed,
                            {"backend": "interpret"})):
        buf = io.StringIO()
        fn(fa_a, fa_b, out_fa=str(tmp_path / f"{who}.fa"),
           ins_bed_out=str(tmp_path / f"{who}.ins.bed"),
           del_bed_out=str(tmp_path / f"{who}.del.bed"), first_pos_ins=7,
           chrom="chrT", out=buf, **where)
        outs[who] = [buf.getvalue()] + [
            (tmp_path / f"{who}{ext}").read_bytes()
            for ext in (".fa", ".ins.bed", ".del.bed")]
    assert outs["port"] == outs["jax"]
    if kind == "related":
        assert outs["port"][2]  # the 6 bp insertion is written


def test_mains_with_device_flag(tmp_path, capsys):
    """The port's argparse entry points with --device cpu: stdout and
    files equal to the JAX tools' (their functions are called with an
    explicit stream: the JAX tools bind sys.stdout when imported)."""
    s_a, s_b = _pair("related")
    fa_a = _write_fa(tmp_path / "a.fa", "a", s_a)
    fa_b = _write_fa(tmp_path / "b.fa", "b", s_b)
    port_ga.main([fa_a, fa_b, "-faOut", str(tmp_path / "port.ga.fa"),
                  "--device", "cpu"])
    port_c2b.main([fa_a, fa_b, "-insBedOut", str(tmp_path / "port.ins.bed"),
                   "-delBedOut", str(tmp_path / "port.del.bed"),
                   "--device", "cpu"])
    buf = io.StringIO()
    jax_ga.global_alignment(fa_a, fa_b, str(tmp_path / "jax.ga.fa"),
                            backend="interpret", out=buf)
    jax_c2b.cigar_to_bed(fa_a, fa_b, ins_bed_out=str(tmp_path / "jax.ins.bed"),
                         del_bed_out=str(tmp_path / "jax.del.bed"),
                         backend="interpret", out=buf)
    got = capsys.readouterr().out
    assert got == buf.getvalue()
    assert got.startswith("Alignment score is ")
    assert "Using AffineGap, Alignment score is " in got
    for ext in (".ga.fa", ".ins.bed", ".del.bed"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()


# The JAX tools' --backend values; on the CPU the JAX's tpu backend runs
# its Pallas kernels in interpret mode, and auto picks numpy.
_BACKENDS = ["auto", "tpu", "numpy", "interpret"]
_JAX_ON_CPU = {"tpu": "interpret"}


@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("tool", ["globalAlignment", "cigarToBed"])
def test_mains_take_backend(tmp_path, capsys, tool, backend):
    """Both entry points take --backend as the JAX parsers do: numpy and
    interpret run the plain versions on the CPU, any other value runs on
    --device (cpu here). Stdout and files equal the JAX tools' with the
    same backend on the CPU."""
    fa_a = _write_fa(tmp_path / "a.fa", "a", "ACGTACGTTT")
    fa_b = _write_fa(tmp_path / "b.fa", "b", "ACGTCGTTT")
    device = [] if backend in ("numpy", "interpret") else ["--device", "cpu"]
    jax_backend = _JAX_ON_CPU.get(backend, backend)
    buf = io.StringIO()
    if tool == "globalAlignment":
        outs = (".fa",)
        port_ga.main([fa_a, fa_b, "-faOut", str(tmp_path / "port.fa"),
                      "--backend", backend, *device])
        jax_ga.global_alignment(fa_a, fa_b, str(tmp_path / "jax.fa"),
                                backend=jax_backend, out=buf)
    else:
        outs = (".ins.bed", ".del.bed")
        port_c2b.main([fa_a, fa_b, "-insBedOut", str(tmp_path / "port.ins.bed"),
                       "-delBedOut", str(tmp_path / "port.del.bed"),
                       "--backend", backend, *device])
        jax_c2b.cigar_to_bed(fa_a, fa_b,
                             ins_bed_out=str(tmp_path / "jax.ins.bed"),
                             del_bed_out=str(tmp_path / "jax.del.bed"),
                             backend=jax_backend, out=buf)
    got = capsys.readouterr().out
    assert got == buf.getvalue()
    assert "Alignment score is " in got
    for ext in outs:
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()
