"""The port's sequence-sharded Gotoh aligner and sharded pipeline step
(gonomics_tpu_torch/parallel: `shard_seq_affine_align`,
`shard_seq_affine_score`, `pipeline_step`, `example_step_inputs`; the
strip mode's plain version `ops.wavefront.affine_fwd_strip_reference`)
on meshes of CPU devices, against the JAX package's functions on the 8
virtual CPU devices that conftest.py gives JAX, whose lowmem backward
runs its Pallas kernels in interpret mode.

Every value is int32 or int8, so every comparison is exact. The JAX
results are computed once a module (the interpret mode is the slow side).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.parallel import example_step_inputs as jax_inputs
from gonomics_tpu.parallel import make_mesh as jax_make_mesh
from gonomics_tpu.parallel import pipeline_step as jax_pipeline_step
from gonomics_tpu.parallel import shard_seq_affine_align as jax_align
from gonomics_tpu.parallel import shard_seq_affine_score as jax_score
from gonomics_tpu_torch import NEG, parallel
from gonomics_tpu_torch.ops import wavefront

GO, GE = -600, -150


def _cpu_mesh(data: int, seq: int):
    return parallel.make_mesh(devices=["cpu"] * (data * seq), data=data,
                              seq=seq)


def _pairs(B: int, n: int, m: int, seed: int):
    """B pairs of n x m: pair 0 a relative of its alpha (a gap, SNPs, an N
    and a negative code), the others random."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 4, (B, n)).astype(np.int8)
    beta = rng.integers(0, 4, (B, m)).astype(np.int8)
    rel = np.resize(np.concatenate([alpha[0, :n // 3], alpha[0, n // 3 + 4:]]),
                    m)
    rel[rng.random(m) < 0.04] = rng.integers(0, 4)
    beta[0] = rel
    alpha[0, rng.integers(0, n, 2)] = [4, -1]
    return alpha, beta


def _indel_pair():
    """tests/test_seq_parallel_align.py:71's 1,024 bp pair with a 12 bp
    deletion and an insertion (seed 7)."""
    rng = np.random.default_rng(7)
    n = 1024
    ref = rng.integers(0, 4, n).astype(np.int8)
    snp = rng.random(n) < 0.02
    mut = np.where(snp, (ref + 1) % 4, ref).astype(np.int8)
    qry = np.concatenate([mut[:400], mut[412:],
                          rng.integers(0, 4, 12).astype(np.int8)])
    return ref[None], qry[None].astype(np.int8)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gs, gops, gi, gj), (ws, wops, wi, wj) in zip(got, want):
        assert (gs, gi, gj) == (int(ws), int(wi), int(wj))
        assert gops.dtype == np.int8
        np.testing.assert_array_equal(gops, np.asarray(wops))


# --- the strip mode's plain version ---------------------------------------

# (B, n, m, K, cuts): lanes 0..n cut into strips [cuts[k], cuts[k + 1]):
# one strip, three uneven ones, and eight with an empty one at the end (the
# JAX's shard of padding lanes only) and an empty one in the middle
_STITCH_CASES = [(3, 37, 29, 8, (0, 38)),
                 (3, 37, 29, 8, (0, 5, 20, 38)),
                 (2, 30, 45, 16, (0, 4, 8, 12, 16, 16, 24, 31, 31)),
                 (2, 1, 20, 8, (0, 1, 2, 2))]


@pytest.mark.parametrize("B,n,m,K,cuts", _STITCH_CASES)
def test_strip_reference_stitched_equals_block(B, n, m, K, cuts):
    """affine_fwd_strip_reference over the strips of each block, each
    strip taking the edge the strip to its left handed on, equals
    affine_fwd_block_reference over all lanes: the end state on every
    block, and the capture of diagonal n + m (which the strips keep, and
    never reset, from the block that holds it on)."""
    a, b = (torch.from_numpy(x) for x in _pairs(B, n, m, n + m))
    ck, cap = wavefront.lowmem_forward(a, b, HUMAN_CHIMP_TWO, GO, GE, K)
    fin = torch.full((B,), n + m, dtype=torch.int32)
    caps = [torch.full((3, B, hi - lo), NEG, dtype=torch.int32)
            for lo, hi in zip(cuts[:-1], cuts[1:])]
    for blk in range(ck.shape[0]):
        want = wavefront.affine_fwd_block_reference(
            a, b, ck[blk], blk * K, n + m, HUMAN_CHIMP_TWO, GO, GE, K)[0]
        edge, outs = None, []
        for c, lo, hi in zip(caps, cuts[:-1], cuts[1:]):
            given = edge
            st, edge = wavefront.affine_fwd_strip(
                a, b, ck[blk][..., lo:hi].contiguous(), edge, blk * K, fin, c,
                lo, HUMAN_CHIMP_TWO, GO, GE, K)
            if hi == lo and given is not None:
                assert torch.equal(edge, given)
            outs.append(st)
        assert torch.equal(torch.cat(outs, dim=3), want), blk
    assert torch.equal(torch.cat(caps, dim=2), cap)


def test_strip_edge_records_the_last_lane():
    """edge_out row t is M, I, D of the strip's last lane on diagonal d0 -
    1 + t: the entry state's two diagonals, then the block's own."""
    B, n, m, K = 2, 20, 30, 8
    a, b = (torch.from_numpy(x) for x in _pairs(B, n, m, 5))
    ck, _ = wavefront.lowmem_forward(a, b, HUMAN_CHIMP_TWO, GO, GE, K)
    fin = torch.zeros(B, dtype=torch.int32)
    lo, hi = 0, 12
    _, edge = wavefront.affine_fwd_strip_reference(
        a, b, ck[2][..., lo:hi].contiguous(), None, 2 * K, fin,
        torch.zeros((3, B, hi - lo), dtype=torch.int32), lo, HUMAN_CHIMP_TWO,
        GO, GE, K)
    # diagonals d0 - 1 and d0 from the checkpoint; d0 + K - 1 from the
    # next checkpoint's slot 0
    assert torch.equal(edge[:, 0], ck[2][:, 0, :, hi - 1].T)
    assert torch.equal(edge[:, 1], ck[2][:, 1, :, hi - 1].T)
    assert torch.equal(edge[:, K], ck[3][:, 0, :, hi - 1].T)


# --- shard_seq_affine_align ------------------------------------------------

# name -> (seq, K, alpha, beta): tests/test_seq_parallel_align.py's shapes
# (n = 300, B = 2, K = 128, seed 3; the indel pair at K = 256), n != m both
# ways, and seq = 3 (uneven strips, the last one shorter)
_ALIGN_CASES = {
    "n300_seq8": (8, 128, *(np.random.default_rng(3).integers(
        0, 4, (2, 2, 300)).astype(np.int8))),
    "indel_seq8": (8, 256, *_indel_pair()),
    "n_below_m_seq8": (8, 64, *_pairs(3, 150, 230, 11)),
    "n_above_m_seq3": (3, 64, *_pairs(2, 230, 150, 12)),
    "n300_seq3": (3, 100, *_pairs(2, 300, 300, 13)),
}


@pytest.fixture(scope="module")
def jax_alignments():
    out = {}
    for name, (seq, K, a, b) in _ALIGN_CASES.items():
        fn = jax_align(jax_make_mesh(seq, data=1, seq=seq), HUMAN_CHIMP_TWO,
                       n=a.shape[1], m=b.shape[1], gap_open=GO,
                       gap_extend=GE, checkersize=K, interpret=True)
        out[name] = fn(a, b)
    return out


@pytest.mark.parametrize("name", list(_ALIGN_CASES))
def test_shard_seq_affine_align_matches_jax(jax_alignments, name):
    seq, K, a, b = _ALIGN_CASES[name]
    fn = parallel.shard_seq_affine_align(
        _cpu_mesh(1, seq), HUMAN_CHIMP_TWO, n=a.shape[1], m=b.shape[1],
        gap_open=GO, gap_extend=GE, checkersize=K)
    got = fn(a, b)
    _assert_same(got, jax_alignments[name])
    _assert_same(got, wavefront.affine_gap_lowmem_batch(
        a, b, HUMAN_CHIMP_TWO, GO, GE, checkersize=K, device="cpu"))
    if name == "indel_seq8":
        ops = got[0][1]
        assert (got[0][2], got[0][3]) == (0, 0)
        assert (ops == 1).any() and (ops == 2).any()


@pytest.mark.parametrize("seq,K", [(2, 16), (5, 32), (8, 8)])
def test_shard_seq_checkpoints_equal_lowmem_forward(seq, K):
    """The gathered checkpoints and the capture equal lowmem_forward's,
    slot for slot (the JAX stacks a checkpoint's two diagonals the other
    way round): a swapped slot would change a cigar only where a block
    boundary falls inside a gap run."""
    a, b = (torch.from_numpy(x) for x in _pairs(3, 45, 61, seq + K))
    ck, cap = parallel.shard_seq_forward(_cpu_mesh(1, seq), a, b,
                                         HUMAN_CHIMP_TWO, GO, GE, K)
    want_ck, want_cap = wavefront.lowmem_forward(a, b, HUMAN_CHIMP_TWO, GO,
                                                 GE, K)
    assert torch.equal(ck, want_ck) and torch.equal(cap, want_cap)


def test_shard_seq_affine_align_takes_tensors_and_refuses_shapes():
    a, b = _pairs(2, 40, 50, 1)
    fn = parallel.shard_seq_affine_align(_cpu_mesh(1, 4), HUMAN_CHIMP_TWO,
                                         n=40, m=50, gap_open=GO,
                                         gap_extend=GE, checkersize=16)
    _assert_same(fn(torch.from_numpy(a), torch.from_numpy(b)), fn(a, b))
    with pytest.raises(ValueError, match="want"):
        fn(a[:, :39], b)


# --- shard_seq_affine_score ------------------------------------------------

def _score_inputs():
    """tests/test_parallel.py:129's four lengths padded to (40, 52), seed
    11, and two pairs whose n_b or fin_b lies outside the grid."""
    rng = np.random.default_rng(11)
    n, m = 40, 52
    lens = [(40, 52), (33, 29), (40, 1), (7, 52)]
    B = len(lens) + 2
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    fin = np.zeros((B, 1), np.int32)
    nv = np.zeros((B, 1), np.int32)
    for b, (nb, mb) in enumerate(lens):
        alpha[b, :nb] = rng.integers(0, 4, nb)
        beta[b, :mb] = rng.integers(0, 4, mb)
        fin[b, 0] = nb + mb
        nv[b, 0] = nb
    fin[4, 0], nv[4, 0] = 30, 41     # a lane past n: the JAX's padding
    fin[5, 0], nv[5, 0] = 0, 0       # diagonal 0, never reached
    return n, m, alpha, beta, fin, nv


@pytest.fixture(scope="module")
def jax_scores():
    n, m, *args = _score_inputs()
    out = {}
    for seq in (8, 3):
        fn = jax_score(jax_make_mesh(seq, data=1, seq=seq), HUMAN_CHIMP_TWO,
                       n=n, m=m, gap_open=GO, gap_extend=GE)
        out[seq] = np.asarray(fn(*args))
    return out


@pytest.mark.parametrize("seq,K", [(8, 1024), (8, 16), (3, 1024), (3, 7)])
def test_shard_seq_affine_score_matches_jax(jax_scores, seq, K,
                                            monkeypatch):
    """At the default block of diagonals (one block here) and at blocks
    of 16 and 7, where each pair's diagonal falls in another block and
    the capture must survive the blocks after it."""
    monkeypatch.setattr(parallel, "SEQ_SCORE_K", K)
    n, m, *args = _score_inputs()
    fn = parallel.shard_seq_affine_score(_cpu_mesh(1, seq), HUMAN_CHIMP_TWO,
                                         n=n, m=m, gap_open=GO,
                                         gap_extend=GE)
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == (6,)
    assert got.tolist() == jax_scores[seq].tolist()
    assert got[4] == got[5] == NEG
    alpha, beta, fin, nv = (torch.from_numpy(x) for x in args)
    res = wavefront.affine_wavefront(alpha, beta, fin, HUMAN_CHIMP_TWO, GO,
                                     GE, False)
    assert got[:4].tolist() == res[torch.arange(4), nv[:4, 0].long()].tolist()


# --- pipeline_step and example_step_inputs ---------------------------------

_STEP_MESHES = [(4, 2), (8, 1), (2, 4)]


def _step_shapes(data: int, seq: int):
    """__graft_entry__.dryrun_multichip's shapes: B = 2 data, n = m = 32,
    genome_len = 64 seq."""
    return 2 * data, 32, 32, 64 * seq


@pytest.fixture(scope="module")
def jax_steps():
    out = {}
    for data, seq in _STEP_MESHES:
        mesh = jax_make_mesh(data * seq, data=data, seq=seq)
        B, n, m, genome_len = _step_shapes(data, seq)
        step = jax_pipeline_step(mesh, n=n, m=m, genome_len=genome_len,
                                 scores=HUMAN_CHIMP_TWO, gap_open=GO,
                                 gap_extend=GE)
        args = jax_inputs(mesh, B=B, n=n, m=m, genome_len=genome_len)
        scores, counts = step(*args)
        out[(data, seq)] = ([np.asarray(x) for x in args], np.asarray(scores),
                            np.asarray(counts))
    return out


@pytest.mark.parametrize("data,seq", _STEP_MESHES)
def test_example_step_inputs_bit_equal_jax(jax_steps, data, seq):
    B, n, m, genome_len = _step_shapes(data, seq)
    got = parallel.example_step_inputs(_cpu_mesh(data, seq), B=B, n=n, m=m,
                                       genome_len=genome_len)
    for g, w in zip(got, jax_steps[(data, seq)][0]):
        assert g.numpy().dtype == w.dtype and g.numpy().shape == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("data,seq", _STEP_MESHES)
def test_pipeline_step_matches_jax(jax_steps, data, seq):
    B, n, m, genome_len = _step_shapes(data, seq)
    mesh = _cpu_mesh(data, seq)
    step = parallel.pipeline_step(mesh, n=n, m=m, genome_len=genome_len,
                                  scores=HUMAN_CHIMP_TWO, gap_open=GO,
                                  gap_extend=GE)
    args = parallel.example_step_inputs(mesh, B=B, n=n, m=m,
                                        genome_len=genome_len)
    scores, counts = step(*args)
    _, want_scores, want_counts = jax_steps[(data, seq)]
    assert scores.dtype == counts.dtype == torch.int32
    assert scores.shape == (B, n + 1) and counts.shape == (genome_len, 13)
    assert np.array_equal(scores.numpy(), want_scores[:, :n + 1])
    assert np.array_equal(counts.numpy(), want_counts)
    # the same step on the unsharded batch, and numpy's count
    whole = wavefront.wavefront_align(*args[:3], HUMAN_CHIMP_TWO,
                                      gap_open=GO, gap_extend=GE,
                                      with_trace=False)
    assert torch.equal(scores, whole)
    pos, base = args[3].numpy(), args[4].numpy()
    ref = np.zeros((genome_len, 13), np.int32)
    np.add.at(ref, (pos.ravel(), base.ravel()), 1)
    assert np.array_equal(counts.numpy(), ref)


@pytest.fixture(scope="module")
def out_of_range_events():
    """Events with bases -1, 13 and 20 and positions -1 and genome_len
    beside real ones, some invalid, on a (4, 2) mesh, and the JAX's
    counts of them."""
    rng = np.random.default_rng(4)
    B, L, genome_len = 8, 50, 120
    pos = rng.integers(-3, genome_len + 3, (B, L)).astype(np.int32)
    base = rng.integers(-2, 16, (B, L)).astype(np.int32)
    base[0, :3] = [-1, 13, 20]
    pos[1, :2] = [-1, genome_len]
    valid = rng.random((B, L)) < 0.8
    alpha, beta = _pairs(B, 16, 12, 9)
    fin = np.full((B, 1), 28, np.int32)
    args = (alpha, beta, fin, pos, base, valid)
    mesh = jax_make_mesh(8, data=4, seq=2)
    step = jax_pipeline_step(mesh, n=16, m=12, genome_len=genome_len,
                             scores=HUMAN_CHIMP_TWO, gap_open=GO,
                             gap_extend=GE)
    return args, genome_len, np.asarray(step(*args)[1])


def test_out_of_range_events_count_nothing(out_of_range_events):
    args, genome_len, want = out_of_range_events
    step = parallel.pipeline_step(_cpu_mesh(4, 2), n=16, m=12,
                                  genome_len=genome_len,
                                  scores=HUMAN_CHIMP_TWO, gap_open=GO,
                                  gap_extend=GE)
    counts = step(*args)[1].numpy()
    assert np.array_equal(counts, want)
    _, _, _, pos, base, valid = args
    ok = valid & (pos >= 0) & (pos < genome_len) & (base >= 0) & (base < 13)
    ref = np.zeros((genome_len, 13), np.int32)
    np.add.at(ref, (pos[ok], base[ok]), 1)
    assert np.array_equal(counts, ref)
    assert counts.sum() == ok.sum() < valid.sum()


def test_pipeline_step_refusals():
    with pytest.raises(ValueError, match="multiple"):
        parallel.pipeline_step(_cpu_mesh(2, 3), n=8, m=8, genome_len=100,
                               scores=HUMAN_CHIMP_TWO, gap_open=GO,
                               gap_extend=GE)
    mesh = _cpu_mesh(4, 1)
    with pytest.raises(ValueError, match="data slices"):
        parallel.example_step_inputs(mesh, B=6, n=8, m=8, genome_len=40)
    step = parallel.pipeline_step(mesh, n=8, m=8, genome_len=40,
                                  scores=HUMAN_CHIMP_TWO, gap_open=GO,
                                  gap_extend=GE)
    args = parallel.example_step_inputs(_cpu_mesh(2, 1), B=6, n=8, m=8,
                                        genome_len=40)
    with pytest.raises(ValueError, match="data slices"):
        step(*args)
    args = parallel.example_step_inputs(mesh, B=8, n=8, m=8, genome_len=40)
    with pytest.raises(ValueError, match="want"):
        step(args[0][:, :7], *args[1:])


def test_seq_strips_cut_like_the_jax():
    """Strip k holds lanes [k s_loc, (k + 1) s_loc) of the JAX's S =
    round_up(n + 1, seq), cut at n + 1; a shard of padding only has no
    strip."""
    mesh = _cpu_mesh(1, 4)
    assert [(lo, hi) for _, lo, hi in parallel.seq_strips(mesh, 9)] == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert [(lo, hi) for _, lo, hi in parallel.seq_strips(mesh, 4)] == [
        (0, 2), (2, 4), (4, 5)]
    assert [(lo, hi) for _, lo, hi in parallel.seq_strips(mesh, 1)] == [
        (0, 1), (1, 2)]


def test_parallel_imports_no_jax():
    """The parallel module and the wavefront ops import neither JAX nor
    the JAX package."""
    code = ("import sys, gonomics_tpu_torch.parallel, "
            "gonomics_tpu_torch.ops.wavefront\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gonomics_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_make_mesh_wants_the_card(monkeypatch):
    """Without a card, make_mesh() raises: the sharded paths never fall
    back to the CPU unless given CPU devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
