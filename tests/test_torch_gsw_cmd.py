"""The port's `gsw align` (gonomics_tpu_torch/cli/gsw_cmd.py, --device
cpu) against the JAX package's `gsw align --engine tpu` (Pallas in
interpret mode): byte-identical SAM files, single and paired, for a
linear reference; for a graph reference byte-identical giraf, and SAM
with -l x.sizes, against both --engine tpu and --engine host; and both
tools without --engine (the host engine) on .fa and .gg references."""

import random

import numpy as np
import pytest

from gonomics_tpu import dna
from gonomics_tpu import graph as jax_graph
from gonomics_tpu.cli import gsw_cmd as jax_gsw
from gonomics_tpu.io.fasta import Fasta
from gonomics_tpu.io.vcf import Vcf
from gonomics_tpu_torch.cli import gsw_cmd as port_gsw


def _write_inputs(tmp_path):
    rng = np.random.default_rng(11)
    chroms = {"chrA": rng.integers(0, 4, 9_000), "chrB": rng.integers(0, 4, 6_000)}
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        for name, seq in chroms.items():
            f.write(f">{name}\n")
            s = dna.to_string(seq.astype(np.int8))
            f.writelines(s[i:i + 50] + "\n" for i in range(0, len(s), 50))

    def fq(path, recs):
        with open(path, "w") as f:
            for name, seq in recs:
                qual = "".join(chr(33 + 20 + (i % 17)) for i in range(len(seq)))
                f.write(f"@{name}\n{dna.to_string(seq)}\n+\n{qual}\n")

    r1, r2 = [], []
    for i in range(10):
        name = ("chrA", "chrB")[i % 2]
        g = chroms[name]
        s = int(rng.integers(0, len(g) - 300))
        a = g[s:s + 70].astype(np.int8).copy()
        a[int(rng.integers(0, 70))] = (a[0] + 1) % 4
        b = dna.reverse_complement(g[s + 180:s + 250].astype(np.int8))
        if i == 7:
            a = rng.integers(0, 4, 70).astype(np.int8)  # unmappable
        r1.append((f"q{i}", a))
        r2.append((f"q{i}", np.ascontiguousarray(b)))
    fq(tmp_path / "r1.fq", r1)
    fq(tmp_path / "r2.fq", r2)
    return str(ref), str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")


# the North star's command line, `gsw align ref.fa reads.fq --engine tpu`,
# with -t as the JAX CLI takes it (and ignores it)
_NORTH_STAR = ["--engine", "tpu", "-t", "4"]


@pytest.mark.parametrize("paired,flags", [
    (False, []), (True, []), (False, _NORTH_STAR), (True, _NORTH_STAR)],
    ids=["single", "paired", "single-engine-tpu-t4", "paired-engine-tpu-t4"])
def test_sam_byte_identical(tmp_path, paired, flags):
    ref, r1, r2 = _write_inputs(tmp_path)
    files = [ref, r1, r2] if paired else [ref, r1]
    want, got = tmp_path / "jax.sam", tmp_path / "port.sam"
    jax_gsw.main(["align", *files, "-o", str(want), "--engine", "tpu",
                  "--batch", "4", *flags])
    port_gsw.main(["align", *files, "-o", str(got), "--device", "cpu",
                   "--engine", "tpu", "--batch", "4", *flags])
    text = got.read_bytes()
    assert text == want.read_bytes()
    assert text.count(b"\n") == 3 + (20 if paired else 10)
    assert b"\tchrB\t" in text


def test_sparse_index_byte_identical(tmp_path):
    ref, r1, _ = _write_inputs(tmp_path)
    want, got = tmp_path / "jax.sam", tmp_path / "port.sam"
    flags = ["--index-mode", "sparse", "--index-step", "4", "--batch", "16"]
    jax_gsw.main(["align", ref, r1, "-o", str(want), "--engine", "tpu",
                  *flags])
    port_gsw.main(["align", ref, r1, "-o", str(got), "--device", "cpu",
                   "--engine", "tpu", *flags])
    assert got.read_bytes() == want.read_bytes()


def test_profile_writes_trace(tmp_path):
    """--profile DIR leaves a torch.profiler trace in DIR and the same
    SAM as a run without it."""
    ref, r1, _ = _write_inputs(tmp_path)
    plain, traced = tmp_path / "plain.sam", tmp_path / "traced.sam"
    port_gsw.main(["align", ref, r1, "-o", str(plain), "--device", "cpu",
                   "--engine", "tpu"])
    prof = tmp_path / "prof"
    port_gsw.main(["align", ref, r1, "-o", str(traced), "--device", "cpu",
                   "--engine", "tpu", "--profile", str(prof)])
    assert traced.read_bytes() == plain.read_bytes()
    trace = prof / "gsw_align.pt.trace.json"
    assert trace.stat().st_size > 0
    assert "traceEvents" in trace.read_text()


@pytest.mark.parametrize("extra", [
    pytest.param(["--multihost"], id="extra1-item 7"),
    pytest.param(["--index-sharding", "prefix"], id="extra2-item 7")])
def test_unported_options_exit(tmp_path, monkeypatch, extra):
    """The two options that exited before their port (ROADMAP item 7)
    now run as the JAX CLI's: --multihost in a group of one process (from
    torchrun's environment) writes the plain SAM and leaves the group;
    --index-sharding prefix without --mesh or --multihost raises the JAX
    aligner's ValueError (no mesh)."""
    import socket

    import torch.distributed as dist

    ref, r1, _ = _write_inputs(tmp_path)
    flags = ["--engine", "tpu", "--batch", "4"]
    plain, got = tmp_path / "plain.sam", tmp_path / "o.sam"
    if extra == ["--multihost"]:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                           ("MASTER_ADDR", "127.0.0.1"),
                           ("MASTER_PORT", str(port))):
            monkeypatch.setenv(key, value)
        port_gsw.main(["align", ref, r1, "-o", str(plain), *flags,
                       "--device", "cpu"])
        port_gsw.main(["align", ref, r1, "-o", str(got), *flags,
                       "--device", "cpu", *extra])
        assert not dist.is_initialized()
        assert got.read_bytes() == plain.read_bytes()
        return
    with pytest.raises(ValueError, match="needs a mesh") as port_err:
        port_gsw.main(["align", ref, r1, "-o", str(got), *flags,
                       "--device", "cpu", *extra])
    with pytest.raises(ValueError) as jax_err:
        jax_gsw.main(["align", ref, r1, "-o", str(plain), *flags, *extra])
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_mesh_byte_identical(tmp_path, paired):
    """--mesh on a .fa reference (the mesh path: the whole local DP a
    read, over one CPU device with --device cpu) writes the SAM of the
    run without it, and of the JAX CLI's --mesh (its 8 virtual devices)."""
    ref, r1, r2 = _write_inputs(tmp_path)
    files = [ref, r1, r2] if paired else [ref, r1]
    plain, meshed = tmp_path / "plain.sam", tmp_path / "mesh.sam"
    flags = ["--device", "cpu", "--engine", "tpu", "--batch", "4"]
    port_gsw.main(["align", *files, "-o", str(plain), *flags])
    port_gsw.main(["align", *files, "-o", str(meshed), *flags, "--mesh"])
    text = meshed.read_bytes()
    assert text == plain.read_bytes()
    assert text.count(b"\n") == 3 + (20 if paired else 10)
    if not paired:
        want = tmp_path / "jax.sam"
        jax_gsw.main(["align", *files, "-o", str(want), "--engine", "tpu",
                      "--batch", "4", "--mesh"])
        assert text == want.read_bytes()


def _write_graph_inputs(tmp_path):
    """A variant graph (SNP, DEL and INS nodes) written as .gg by the JAX
    package, its .sizes file, and reads along its paths as R1/R2 fastqs
    (R2 the reverse complement of a stretch downstream of R1), one of
    them random."""
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 900).astype(np.int8)

    def rec(pos, r, a, info):
        return Vcf(chrom="chr1", pos=pos, id=".", ref=r, alt=[a], info=info)

    vcfs = [rec(100, dna.to_string(ref[99:100]),
                dna.to_string((ref[99:100] + 1) % 4), "SVTYPE=SNP"),
            rec(400, dna.to_string(ref[399:404]), dna.to_string(ref[399:400]),
                "SVTYPE=DEL"),
            rec(650, dna.to_string(ref[649:650]),
                dna.to_string(ref[649:650]) + "GGA", "SVTYPE=INS")]
    g = jax_graph.variant_graph([Fasta("chr1", ref)], {"chr1": vcfs})
    gg = tmp_path / "ref.gg"
    jax_graph.write(str(gg), g)
    sizes = tmp_path / "ref.sizes"
    sizes.write_text("chr1\t900\n")

    def fq(path, recs):
        with open(path, "w") as f:
            for name, seq in recs:
                qual = "".join(chr(33 + 20 + (i % 17)) for i in range(len(seq)))
                f.write(f"@{name} x\n{dna.to_string(seq)}\n+\n{qual}\n")

    r1, r2 = [], []
    for i in range(8):
        s = int(rng.integers(0, 900 - 180))
        a = ref[s:s + 60].copy()
        a[int(rng.integers(0, 60))] = (a[5] + 1) % 4
        b = dna.reverse_complement(ref[s + 110:s + 170]).astype(np.int8)
        if i == 5:
            a = rng.integers(0, 4, 60).astype(np.int8)
        r1.append((f"g{i}", a))
        r2.append((f"g{i}", np.ascontiguousarray(b)))
    fq(tmp_path / "g1.fq", r1)
    fq(tmp_path / "g2.fq", r2)
    return (str(gg), str(sizes), str(tmp_path / "g1.fq"),
            str(tmp_path / "g2.fq"))


@pytest.mark.parametrize("extra", [
    ["--mesh"], ["--multihost"], ["--index-sharding", "prefix"]],
    ids=["mesh", "multihost", "index-sharding-prefix"])
def test_graph_ignores_multi_device_flags(tmp_path, extra):
    """A .gg reference on --engine tpu goes to the graph engine before any
    multi-device flag is read (JAX cli/gsw_cmd.py:55-57): the giraf of
    the run without the flag."""
    gg, _, r1, _ = _write_graph_inputs(tmp_path)
    plain, flagged = tmp_path / "plain.giraf", tmp_path / "flagged.giraf"
    for out, flags in ((plain, []), (flagged, extra)):
        port_gsw.main(["align", gg, r1, "-o", str(out), "--device", "cpu",
                       "--engine", "tpu", "--batch", "5", "-i", "21", "-w",
                       "8", *flags])
    assert flagged.read_bytes() == plain.read_bytes()
    assert plain.read_bytes().count(b"\n") == 8


@pytest.mark.parametrize("out", ["giraf", "sam"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_graph_byte_identical(tmp_path, paired, out):
    gg, sizes, r1, r2 = _write_graph_inputs(tmp_path)
    files = [gg, r1, r2] if paired else [gg, r1]
    flags = ["-i", "21", "-w", "8"] + (["-l", sizes] if out == "sam" else [])
    got = tmp_path / "port.out"
    port_gsw.main(["align", *files, "-o", str(got), "--device", "cpu",
                   "--batch", "5", *flags])
    text = got.read_bytes()
    for engine in ("tpu", "host"):
        want = tmp_path / f"{engine}.out"
        jax_gsw.main(["align", *files, "-o", str(want), "--engine", engine,
                      "--batch", "5", *flags])
        assert text == want.read_bytes(), engine
    lines = text.decode().splitlines()
    body = [ln for ln in lines if not ln.startswith("@")]
    assert len(body) == (16 if paired else 8)
    if out == "sam":
        assert lines[:2] == ["@HD\tVN:1.6\tSO:unsorted", "@SQ\tSN:chr1\tLN:900"]
        assert sum(not int(ln.split("\t")[1]) & 4 for ln in body) >= 6
    else:
        assert sum(ln.split("\t")[5] != "0::0" for ln in body) >= 6


def _write_default_engine_inputs(tmp_path):
    """A 3,000-base chr1 (random.seed(1)) as .fa, and as a .gg variant
    graph with a SNP and a deletion; its .sizes; 150-base reads at 100,
    600 and 1,100 (one with a mismatch) and a random one, with R2 the
    reverse complement of the 150 bases 250 downstream."""
    random.seed(1)
    ref = "".join(random.choice("ACGT") for _ in range(3000))
    (tmp_path / "ref.fa").write_text(
        ">chr1\n" + "".join(ref[i:i + 60] + "\n" for i in range(0, 3000, 60)))
    codes = dna.from_string(ref)
    vcfs = [Vcf(chrom="chr1", pos=700, id=".", ref=ref[699],
                alt=["ACGT"[("ACGT".index(ref[699]) + 1) % 4]],
                info="SVTYPE=SNP"),
            Vcf(chrom="chr1", pos=1200, id=".", ref=ref[1199:1204],
                alt=[ref[1199]], info="SVTYPE=DEL")]
    g = jax_graph.variant_graph([Fasta("chr1", codes)], {"chr1": vcfs})
    jax_graph.write(str(tmp_path / "ref.gg"), g)
    (tmp_path / "ref.sizes").write_text("chr1\t3000\n")

    def rc(s):
        return s[::-1].translate(str.maketrans("ACGT", "TGCA"))

    r1, r2 = [], []
    for k, s in enumerate((100, 600, 1100)):
        read = ref[s:s + 150]
        if k == 1:
            read = read[:40] + ("A" if read[40] != "A" else "C") + read[41:]
        r1.append(read)
        r2.append(rc(ref[s + 250:s + 400]))
    r1.append("".join(random.choice("ACGT") for _ in range(150)))
    r2.append(rc(ref[2000:2150]))
    for name, reads in (("r1.fq", r1), ("r2.fq", r2)):
        (tmp_path / name).write_text("".join(
            f"@r{k}\n{read}\n+\n{'I' * len(read)}\n"
            for k, read in enumerate(reads)))
    return {ext: str(tmp_path / f"ref.{ext}") for ext in ("fa", "gg", "sizes")}


@pytest.mark.parametrize("sizes", [False, True], ids=["giraf", "sam"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("ext", ["fa", "gg"])
def test_default_engine_byte_identical(tmp_path, ext, paired, sizes):
    """Without --engine both tools run the host engine: a .fa reference
    as a linear graph, giraf (SAM with -l); the port's output is the
    JAX's byte for byte, and an explicit --engine host is the same."""
    refs = _write_default_engine_inputs(tmp_path)
    files = [refs[ext], str(tmp_path / "r1.fq")]
    if paired:
        files.append(str(tmp_path / "r2.fq"))
    flags = ["-l", refs["sizes"]] if sizes else []
    want = tmp_path / "jax.out"
    jax_gsw.main(["align", *files, "-o", str(want), *flags])
    text = want.read_bytes()
    for engine in ([], ["--engine", "host"]):
        got = tmp_path / "port.out"
        port_gsw.main(["align", *files, "-o", str(got), "--device", "cpu",
                       *engine, *flags])
        assert got.read_bytes() == text, engine
    lines = text.decode().splitlines()
    body = [ln for ln in lines if not ln.startswith("@")]
    assert len(body) == (8 if paired else 4)
    if sizes:
        assert lines[:2] == ["@HD\tVN:1.6\tSO:unsorted",
                             "@SQ\tSN:chr1\tLN:3000"]
    else:
        assert not lines[0].startswith("@")
        assert sum(ln.split("\t")[5] != "0::0" for ln in body) >= 3
