"""The port's ReadAligner (gonomics_tpu_torch/read_align.py, on the CPU)
against the JAX package's TpuReadAligner (Pallas in interpret mode):
equal device result rows and byte-equal SAM text on the same reads."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gonomics_tpu import dna
from gonomics_tpu.io.fasta import Fasta
from gonomics_tpu.io.fastq import Fastq
from gonomics_tpu.tpu_align import TpuReadAligner
from gonomics_tpu_torch import native, read_align
from gonomics_tpu_torch.io.fasta import Fasta as TFasta
from gonomics_tpu_torch.io.fastq import Fastq as TFastq


def _genome():
    rng = np.random.default_rng(0)
    return rng.integers(0, 4, 20_000).astype(np.int8)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def aligners(request):
    genome = _genome()
    jax_al = TpuReadAligner([Fasta("chr1", genome)], backend="interpret",
                            index_mode=request.param)
    port_al = read_align.ReadAligner([TFasta("chr1", genome)], device="cpu",
                                     index_mode=request.param)
    return genome, jax_al, port_al


def _read(genome, start, length=80, rc=False, mut=(), name=None):
    seq = genome[start:start + length].copy()
    for p in mut:
        seq[p] = (seq[p] + 1) % 4
    if rc:
        seq = dna.reverse_complement(seq).astype(np.int8)
    return Fastq(name or f"r{start}", seq,
                 (30 + np.arange(length) % 11).astype(np.uint8))


def _reads(genome):
    """Forward and reverse-complement reads with SNPs, a deletion, an
    insertion, lowercase bases and an unmappable read, all of 80 bp."""
    rng = np.random.default_rng(7)
    reads = [_read(genome, s, rc=bool(i % 2), mut=(5, 40))
             for i, s in enumerate((100, 5_000, 12_345, 7_777, 19_000))]
    reads.append(Fastq("del", np.concatenate(
        [genome[3000:3050], genome[3053:3083]]).astype(np.int8),
        np.full(80, 30, np.uint8)))
    reads.append(Fastq("ins", np.concatenate(
        [genome[9000:9040], rng.integers(0, 4, 4), genome[9040:9076]]
    ).astype(np.int8), np.full(80, 31, np.uint8)))
    low = genome[15_000:15_080].copy()
    low[10:20] += 5
    reads.append(Fastq("lower", low, np.full(80, 32, np.uint8)))
    reads.append(Fastq("junk", rng.integers(0, 4, 80).astype(np.int8),
                       np.full(80, 30, np.uint8)))
    return reads


def _port(reads):
    return [TFastq(r.name, r.seq, r.qual) for r in reads]


def test_device_result_rows_equal(aligners):
    genome, jax_al, port_al = aligners
    reads = _reads(genome)
    want = np.asarray(jax_al.align_batch_async(reads)[5])
    got = port_al.align_batch_async(_port(reads))[5].numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want[:len(reads)])


def test_sam_text_equal(aligners):
    genome, jax_al, port_al = aligners
    reads = _reads(genome)
    want = jax_al.finish_batch_lines(jax_al.align_batch_async(reads))
    got = port_al.finish_batch_lines(port_al.align_batch_async(_port(reads)))
    assert got == want
    assert got.count("\n") == len(reads)
    want_obj = [s.to_string() for s in jax_al.align_batch(reads)]
    got_obj = [s.to_string() for s in port_al.align_batch(_port(reads))]
    assert got_obj == want_obj
    assert "".join(s + "\n" for s in got_obj) == got


def test_non_uniform_lengths_equal(aligners):
    genome, jax_al, port_al = aligners
    reads = [_read(genome, 400, 80), _read(genome, 6_000, 64, rc=True),
             _read(genome, 11_000, 72, mut=(3,))]
    want = jax_al.finish_batch_lines(jax_al.align_batch_async(reads))
    got = port_al.finish_batch_lines(port_al.align_batch_async(_port(reads)))
    assert got == want


def test_pairs_equal(aligners):
    genome, jax_al, port_al = aligners
    pairs = []
    for s in (2_000, 8_000, 14_000):
        fwd = _read(genome, s)
        rev = Fastq(f"p{s}", dna.reverse_complement(
            genome[s + 200:s + 280]).astype(np.int8),
            np.full(80, 30, np.uint8))
        pairs.append((fwd, rev))
    want = [s.to_string() for s in jax_al.align_pairs(pairs)]
    got = [s.to_string() for s in port_al.align_pairs(
        [(TFastq(a.name, a.seq, a.qual), TFastq(b.name, b.seq, b.qual))
         for a, b in pairs])]
    assert got == want
    assert "\t=\t" in got[0]


@pytest.mark.parametrize("index_mode", ["dense", "sparse"])
def test_numpy_fallbacks_equal(monkeypatch, index_mode):
    # without the native host library the port seeds, votes and emits SAM
    # in numpy, and still writes the JAX package's text
    genome = _genome()
    reads = _reads(genome)
    jax_al = TpuReadAligner([Fasta("chr1", genome)], backend="interpret",
                            index_mode=index_mode)
    want = jax_al.finish_batch_lines(jax_al.align_batch_async(reads))
    monkeypatch.setattr(native, "_load", lambda: None)
    port_al = read_align.ReadAligner([TFasta("chr1", genome)], device="cpu",
                                     index_mode=index_mode)
    assert port_al._sparse is None
    got = port_al.finish_batch_lines(port_al.align_batch_async(_port(reads)))
    assert got == want


def test_from_state_and_load_of_jax_index(tmp_path):
    genome = _genome()
    jax_al = TpuReadAligner([Fasta("chr1", genome[:12_000]),
                             Fasta("chr2", genome[12_000:])],
                            backend="interpret")
    path = str(tmp_path / "idx.npz")
    jax_al.save_index(path)
    reads = [_read(genome, s) for s in (100, 5_000, 13_345)]
    want = [s.to_string() for s in jax_al.align_batch(reads)]
    loaded = read_align.ReadAligner.load(path, device="cpu")
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    rebuilt = read_align.ReadAligner.from_state(state, device="cpu")
    for al in (loaded, rebuilt):
        assert (al.idx_codes == jax_al.idx_codes).all()
        assert [s.to_string() for s in al.align_batch(_port(reads))] == want
    # the port's own file round-trips, scores and gap included
    path2 = str(tmp_path / "port_idx.npz")
    loaded.save_index(path2)
    again = read_align.ReadAligner.load(path2, device="cpu")
    assert [s.to_string() for s in again.align_batch(_port(reads))] == want
    assert TpuReadAligner.load(path2, backend="interpret").idx_pos.tolist() \
        == jax_al.idx_pos.tolist()


def test_package_imports_no_jax():
    code = ("import sys, gonomics_tpu_torch, gonomics_tpu_torch.read_align, "
            "gonomics_tpu_torch.cli.gsw_cmd\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gonomics_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    records = [TFasta("chr1", _genome()[:2_000])]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        read_align.ReadAligner(records)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        read_align.ReadAligner(records, device="cuda")


@pytest.mark.parametrize("kwargs", [{"index_sharding": "prefix"}])
def test_multi_device_options_not_ported(kwargs):
    """The option that raised NotImplementedError before its port (ROADMAP
    item 7) runs as the JAX aligner's: without a mesh it raises the JAX's
    ValueError; on a mesh it gives the replicated index's SAM."""
    from gonomics_tpu_torch.parallel import make_mesh

    genome = _genome()
    with pytest.raises(ValueError) as port_err:
        read_align.ReadAligner([TFasta("chr1", genome)], device="cpu",
                               **kwargs)
    with pytest.raises(ValueError) as jax_err:
        TpuReadAligner([Fasta("chr1", genome)], **kwargs)
    assert str(port_err.value) == str(jax_err.value)
    mesh = make_mesh(devices=["cpu"] * 2, data=2)
    sharded = read_align.ReadAligner([TFasta("chr1", genome)], mesh=mesh,
                                     **kwargs)
    plain = read_align.ReadAligner([TFasta("chr1", genome)], device="cpu")
    reads = [TFastq(r.name, r.seq, r.qual) for r in _reads(genome)]
    assert ([s.to_string() for s in sharded.align_batch(reads)]
            == [s.to_string() for s in plain.align_batch(reads)])
