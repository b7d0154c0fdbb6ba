"""The port's prefix-sharded seed index (gonomics_tpu_torch/read_align.py
`split_index_prefix`, parallel `place_index_chunks` and
`shard_seed_lookup`, `ReadAligner(index_sharding="prefix")`) on the CPU
against the JAX package's (tpu_align.py:133-159, parallel/__init__.py:
144-207, tpu_align.py:267-289) on conftest's 8 virtual CPU devices; the
port's mesh repeats the CPU device where the JAX mesh has those.

The contract (tests/test_parallel.py:163, :180): the chunks never split
a code's run, and the prefix-sharded SAM is byte-identical to the
replicated index's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu import dna
from gonomics_tpu.io.fasta import Fasta
from gonomics_tpu.io.fastq import Fastq
from gonomics_tpu.parallel import make_mesh as jax_make_mesh
from gonomics_tpu.parallel import shard_seed_lookup as jax_shard_seed_lookup
from gonomics_tpu.tpu_align import TpuReadAligner
from gonomics_tpu.tpu_align import build_seed_index as jax_build_seed_index
from gonomics_tpu.tpu_align import split_index_prefix as jax_split
from gonomics_tpu_torch import parallel
from gonomics_tpu_torch.io.fasta import Fasta as TFasta
from gonomics_tpu_torch.io.fastq import Fastq as TFastq
from gonomics_tpu_torch.read_align import (_PAD_CODE, ReadAligner,
                                           build_seed_index,
                                           split_index_prefix)

CPU8 = ["cpu"] * 8
BAD_WINDOW = np.uint64(1) << np.uint64(62)  # read_align._batch_codes


def _tandem_genome():
    """test_split_index_prefix_boundaries's genome (test_parallel.py:
    180): 40 copies of a 30 bp unit, whose k-mers each have a run of 40
    (past max_hits), then 2 kbp of random bases."""
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 4, 30).astype(np.int8)
    return np.concatenate([np.tile(unit, 40),
                           rng.integers(0, 4, 2000).astype(np.int8)])


def _table(kind: str):
    if kind == "random":
        genome = np.random.default_rng(3).integers(0, 4, 5000).astype(np.int8)
    elif kind == "tandem":
        genome = _tandem_genome()
    else:  # "tiny": 3 entries, fewer than most shard counts
        genome = np.random.default_rng(4).integers(0, 4, 23).astype(np.int8)
    return build_seed_index(genome, 21)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
@pytest.mark.parametrize("kind", ["random", "tandem", "tiny"])
def test_split_index_prefix_equals_jax(kind, n_shards):
    codes, pos = _table(kind)
    if kind == "random":  # the JAX builder's table is the port's
        for g, w in zip((codes, pos), jax_build_seed_index(
                np.random.default_rng(3).integers(0, 4, 5000).astype(np.int8),
                21)):
            np.testing.assert_array_equal(g, w)
    got = split_index_prefix(codes, pos, n_shards)
    want = jax_split(codes, pos, n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    ck = got[0]
    real = ck[ck != _PAD_CODE]
    assert len(real) == len(codes)
    for i in range(n_shards - 1):  # no run straddles two chunks
        last = ck[i][ck[i] != _PAD_CODE]
        first = ck[i + 1][ck[i + 1] != _PAD_CODE]
        if len(last) and len(first):
            assert last[-1] != first[0]


def test_split_index_prefix_keeps_int64_positions():
    """Positions past 2^31 stay int64 (the JAX casts them to int32, which
    wraps); positions that fit come back int32, as the JAX's."""
    codes = np.array([1, 1, 5, 9, 9, 9], np.uint64)
    pos = np.array([0, 2 ** 31 + 5, 7, 2 ** 32, 3, 2 ** 33], np.int64)
    ck, ps = split_index_prefix(codes, pos, 2)
    assert ps.dtype == np.int64
    assert ck.tolist() == [[1, 1, 5], [9, 9, 9]]
    assert ps.tolist() == [[0, 2 ** 31 + 5, 7], [2 ** 32, 3, 2 ** 33]]
    assert split_index_prefix(codes, pos % 100, 2)[1].dtype == np.int32


def test_code_keys_keep_unsigned_order():
    codes = np.array([0, 1, 2 ** 40, (1 << 62) - 1, 1 << 62, 1 << 63,
                      (1 << 64) - 1], np.uint64)
    keys = parallel.code_keys(codes)
    assert keys.dtype == torch.int64
    assert bool((keys[1:] > keys[:-1]).all())
    assert int(keys[0]) == -(1 << 63) and int(keys[5]) == 0


def _queries(ck: np.ndarray, codes: np.ndarray, rng) -> np.ndarray:
    """(B, K) query codes: random table codes and non-codes, the pad code,
    the bad-window code, codes above every real one, and each chunk's
    first and last real entry."""
    special = [_PAD_CODE, BAD_WINDOW, codes.max() + np.uint64(1),
               BAD_WINDOW - np.uint64(1), np.uint64(0)]
    for row in ck:
        real = row[row != _PAD_CODE]
        if len(real):
            special += [real[0], real[-1]]
    q = np.concatenate([np.array(special, np.uint64),
                        rng.choice(codes, 40),
                        rng.integers(0, 1 << 42, 11).astype(np.uint64)])
    q = np.concatenate([q, rng.choice(codes, (-len(q)) % 8)])
    return q.reshape(-1, 8)


@pytest.mark.parametrize("data", [1, 4, 8])
def test_shard_seed_lookup_equals_jax(data):
    codes, pos = build_seed_index(_tandem_genome(), 21)
    ck, ps = split_index_prefix(codes, pos, data)
    q = _queries(ck, codes, np.random.default_rng(data))
    H = 8
    jax_fn = jax_shard_seed_lookup(jax_make_mesh(data, data=data, seq=1),
                                   max_hits=H)
    whp, wvalid = jax_fn(jnp.asarray((ck >> np.uint64(32)).astype(np.uint32)),
                         jnp.asarray(ck.astype(np.uint32)), jnp.asarray(ps),
                         jnp.asarray((q >> np.uint64(32)).astype(np.uint32)),
                         jnp.asarray(q.astype(np.uint32)))
    mesh = parallel.make_mesh(data, data=data, seq=1, devices=CPU8)
    keys, cpos = parallel.place_index_chunks(mesh, ck, ps)
    assert [k.numel() for k in keys] == [ck.shape[1]] * data
    hp, valid = parallel.shard_seed_lookup(mesh, max_hits=H)(
        keys, cpos, parallel.code_keys(q))
    assert hp.shape == valid.shape == (*q.shape, H)
    assert hp.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(hp.numpy(), np.asarray(whp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    # a run past max_hits is cut at H, and junk finds nothing
    run = valid.numpy().sum(axis=2).ravel()
    assert run.max() == H and (run == 0).any()
    assert (hp.numpy()[~valid.numpy()] == -1).all()


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


@pytest.mark.parametrize("data,n_reads,paired", [
    (8, 24, False), (4, 13, False), (8, 16, True), (4, 22, True)],
    ids=["data8", "data4-uneven", "data8-pairs", "data4-pairs-uneven"])
def test_prefix_sharded_index_matches_jax_and_replicated(data, n_reads,
                                                          paired):
    """test_prefix_sharded_index_matches_replicated (test_parallel.py:163)
    for the port: its prefix SAM equals the JAX prefix SAM and the port's
    replicated mesh SAM, single reads and pairs."""
    rng = np.random.default_rng(6)
    genome = np.concatenate([rng.integers(0, 4, 30000).astype(np.int8),
                             _tandem_genome()])
    reads = _make_reads(genome, n_reads, 60, seed=data)
    jax_al = TpuReadAligner([Fasta("chr1", genome)], min_score=600,
                            mesh=jax_make_mesh(data, data=data, seq=1),
                            index_sharding="prefix")
    mesh = parallel.make_mesh(data, data=data, seq=1, devices=CPU8)
    pref = ReadAligner([TFasta("chr1", genome)], min_score=600, mesh=mesh,
                       index_sharding="prefix")
    repl = ReadAligner.from_state(pref.state(), min_score=600, mesh=mesh)
    if paired:
        pairs = list(zip(reads[0::2], reads[1::2]))
        ports = list(zip(_port(reads[0::2]), _port(reads[1::2])))
        want = _sam(jax_al.align_pairs(pairs))
        got = _sam(pref.align_pairs(ports))
        assert _sam(repl.align_pairs(ports)) == got
    else:
        want = _sam(jax_al.align_batch(reads))
        got = _sam(pref.align_batch(_port(reads)))
        assert _sam(repl.align_batch(_port(reads))) == got
        handle = pref.align_batch_async(_port(reads))
        assert pref.finish_batch_lines(handle) == "".join(
            s + "\n" for s in got)
    assert got == want
    assert sum("\tchr1\t" in s for s in got) >= n_reads - 1


def test_prefix_lookup_never_reads_the_host_table(monkeypatch):
    """The prefix aligner seeds through the chunks alone: the host table
    and the native seed_vote are not read."""
    from gonomics_tpu_torch import native

    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    reads = _port(_make_reads(genome, 9, 60, seed=8))
    mesh = parallel.make_mesh(3, data=3, seq=1, devices=CPU8)
    al = ReadAligner([TFasta("chr1", genome)], min_score=600, mesh=mesh,
                     index_sharding="prefix")
    want = _sam(al.align_batch(reads))
    al.idx_codes = al.idx_pos = None
    monkeypatch.setattr(native, "seed_vote", None)
    assert _sam(al.align_batch(reads)) == want
    assert sum("\tchr1\t" in s for s in want) == 9


def test_prefix_from_a_jax_index_file(tmp_path):
    """ReadAligner.load(index_sharding="prefix") on a file the JAX aligner
    saved: the JAX prefix SAM."""
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    reads = _make_reads(genome, 10, 60, seed=9)
    jax_al = TpuReadAligner([Fasta("chr1", genome)], min_score=600)
    path = str(tmp_path / "idx.npz")
    jax_al.save_index(path)
    mesh = parallel.make_mesh(4, data=4, seq=1, devices=CPU8)
    al = ReadAligner.load(path, min_score=600, mesh=mesh,
                          index_sharding="prefix")
    want = _sam(TpuReadAligner.load(
        path, min_score=600, mesh=jax_make_mesh(4, data=4, seq=1),
        index_sharding="prefix").align_batch(reads))
    assert _sam(al.align_batch(_port(reads))) == want


def test_prefix_errors():
    records = [TFasta("chr1", np.zeros(2_000, np.int8))]
    with pytest.raises(ValueError, match="needs a mesh") as port_err:
        ReadAligner(records, device="cpu", index_sharding="prefix")
    with pytest.raises(ValueError) as jax_err:
        TpuReadAligner([Fasta("chr1", np.zeros(2_000, np.int8))],
                       index_sharding="prefix")
    assert str(port_err.value) == str(jax_err.value)
    mesh = parallel.make_mesh(2, data=2, devices=CPU8)
    with pytest.raises(ValueError, match="index_mode='dense'"):
        ReadAligner(records, mesh=mesh, index_sharding="prefix",
                    index_mode="sparse")
    with pytest.raises(ValueError, match="unknown index_sharding"):
        ReadAligner(records, mesh=mesh, index_sharding="suffix")
