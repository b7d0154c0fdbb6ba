"""The port's data-parallel mesh (gonomics_tpu_torch/parallel: `make_mesh`,
`shard_local_align`; `ReadAligner(mesh=)`) on the CPU against the JAX
package's mesh, which conftest.py gives 8 virtual CPU devices: the port's
mesh repeats the CPU device where the JAX mesh has those.

The contract (tests/test_parallel.py:42-70): sharded output is
byte-identical to single-device output, for any mesh shape. Here the
port's mesh SAM equals the JAX mesh SAM and the port's own unmeshed SAM,
byte for byte, at data = 8 and 4, with empty and uneven slices.
"""

import numpy as np
import pytest
import torch

from gonomics_tpu import dna
from gonomics_tpu.io.fasta import Fasta
from gonomics_tpu.io.fastq import Fastq
from gonomics_tpu.parallel import make_mesh as jax_make_mesh
from gonomics_tpu.tpu_align import TpuReadAligner
from gonomics_tpu_torch import parallel
from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu_torch.io.fasta import Fasta as TFasta
from gonomics_tpu_torch.io.fastq import Fastq as TFastq
from gonomics_tpu_torch.ops import wavefront
from gonomics_tpu_torch.read_align import ReadAligner

CPU8 = ["cpu"] * 8


def _make_reads(genome, n_reads, read_len, seed=0):
    """tests/test_parallel.py's reads: a SNP each, every other one
    reverse-complemented."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len))
        seq = genome[start:start + read_len].copy()
        p = int(rng.integers(0, read_len))
        seq[p] = (seq[p] + 1) % 4
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(Fastq(f"r{i}", seq, np.full(read_len, 30, np.uint8)))
    return reads


def _port(reads):
    return [TFastq(r.name, r.seq, r.qual) for r in reads]


def _sam(sams):
    return [s.to_string() for s in sams]


def test_sharded_align_matches_jax_and_single_device():
    # test_parallel.py:42's inputs: 20 kbp, 24 reads of 60 bp, data = 8
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    reads = _make_reads(genome, 24, 60)
    jax_sharded = TpuReadAligner([Fasta("chr1", genome)], min_score=600,
                                 mesh=jax_make_mesh(8, data=8, seq=1))
    mesh = parallel.make_mesh(8, data=8, seq=1, devices=CPU8)
    sharded = ReadAligner([TFasta("chr1", genome)], min_score=600,
                          mesh=mesh, device="cpu")
    single = ReadAligner([TFasta("chr1", genome)], min_score=600,
                         device="cpu")
    want = _sam(jax_sharded.align_batch(reads))
    got = _sam(sharded.align_batch(_port(reads)))
    assert got == want
    assert _sam(single.align_batch(_port(reads))) == got
    assert any("\t0\tchr1\t" in s or "\t16\tchr1\t" in s for s in got)
    # the native bulk formatter reads the mesh path's (L + W)-step walks
    handle = sharded.align_batch_async(_port(reads))
    assert handle[-1] == 60 + 108
    assert sharded.finish_batch_lines(handle) == "".join(
        s + "\n" for s in got)


def test_sharded_align_pairs_matches_jax_and_single_device():
    # test_parallel.py:57's inputs: 16 reads of 50 bp in pairs, data = 4
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    reads = _make_reads(genome, 16, 50)
    pairs = list(zip(reads[0::2], reads[1::2]))
    jax_sharded = TpuReadAligner([Fasta("chr1", genome)], min_score=500,
                                 mesh=jax_make_mesh(4, data=4, seq=1))
    mesh = parallel.make_mesh(4, data=4, seq=1, devices=CPU8)
    sharded = ReadAligner([TFasta("chr1", genome)], min_score=500,
                          mesh=mesh, device="cpu")
    single = ReadAligner([TFasta("chr1", genome)], min_score=500,
                         device="cpu")
    port_pairs = list(zip(_port(reads[0::2]), _port(reads[1::2])))
    want = _sam(jax_sharded.align_pairs(pairs))
    got = _sam(sharded.align_pairs(port_pairs))
    assert got == want
    assert _sam(single.align_pairs(port_pairs)) == got


@pytest.mark.parametrize("B", [3, 13], ids=["empty-slices", "uneven"])
def test_sharded_align_slices(B):
    """B = 3 over data = 8 leaves five slices empty; B = 13 gives slices
    of 2 and 1 reads. Both equal the JAX mesh and the unmeshed port; the
    index comes through from_state with the mesh."""
    rng = np.random.default_rng(B)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    reads = _make_reads(genome, B, 60, seed=B)
    jax_sharded = TpuReadAligner([Fasta("chr1", genome)], min_score=600,
                                 mesh=jax_make_mesh(8, data=8, seq=1))
    single = ReadAligner([TFasta("chr1", genome)], min_score=600,
                         device="cpu")
    mesh = parallel.make_mesh(8, data=8, seq=1, devices=CPU8)
    sharded = ReadAligner.from_state(single.state(), min_score=600,
                                     mesh=mesh, device="cpu")
    got = _sam(sharded.align_batch(_port(reads)))
    assert got == _sam(jax_sharded.align_batch(reads))
    assert got == _sam(single.align_batch(_port(reads)))


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_make_mesh_axes_match_jax(n_devices):
    cases = [{}, {"data": n_devices}, {"data": 1}, {"seq": 1}]
    if n_devices % 2 == 0:
        cases += [{"seq": 2}, {"data": n_devices // 2}]
    for kw in cases:
        port = parallel.make_mesh(n_devices, devices=CPU8, **kw)
        want = dict(jax_make_mesh(n_devices, **kw).shape)
        assert port.shape == want, kw
        assert port.devices == [[torch.device("cpu")] * want["seq"]] * \
            want["data"]
    # every device given, by default
    assert parallel.make_mesh(devices=CPU8[:n_devices]).shape == dict(
        jax_make_mesh(n_devices).shape)


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="grid"):
        parallel.make_mesh(4, data=4, seq=2, devices=CPU8[:4])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()


def test_shard_local_align_equals_unsharded():
    """shard_local_align's outputs in batch order equal local_align_full
    on the whole batch, for data = 1, 4 (uneven slices), 8 over 5 reads
    (empty slices) and a (4, 2) grid whose seq replicas run nothing."""
    rng = np.random.default_rng(4)
    n, m = 30, 78
    wins = rng.integers(0, 4, (5, m)).astype(np.int8)
    reads = np.ascontiguousarray(wins[:, 24:24 + n])
    reads[:, ::7] = rng.integers(0, 4, (5, 5))
    args = [torch.from_numpy(x) for x in (
        reads, wins, np.array([n, n, 20, 0, n], np.int32),
        np.full(5, m, np.int32))]
    want = wavefront.local_align_full(*args, HUMAN_CHIMP_TWO, -600)
    for kw in ({"data": 1}, {"data": 4}, {"data": 8}, {"data": 4, "seq": 2}):
        mesh = parallel.make_mesh(devices=CPU8, **kw)
        got = parallel.shard_local_align(mesh, HUMAN_CHIMP_TWO, n=n, m=m,
                                         gap=-600)(*args)
        assert len(got) == 6
        for g, w in zip(got, want):
            assert torch.equal(g, w), kw
    with pytest.raises(ValueError):
        parallel.shard_local_align(mesh, HUMAN_CHIMP_TWO, n=n + 1, m=m,
                                   gap=-600)(*args)


def test_mesh_device_must_be_its_first():
    mesh = parallel.make_mesh(2, data=2, devices=CPU8)
    records = [TFasta("chr1", np.zeros(2_000, np.int8))]
    assert ReadAligner(records, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        ReadAligner(records, mesh=mesh, device="cuda:0")
