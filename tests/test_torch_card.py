"""The port's CUDA kernels against their plain PyTorch versions, on the
card (exact equality). They skip without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them; there the repository's conftest (which imports
JAX) is skipped:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from gonomics_tpu_torch import align, dna
from gonomics_tpu_torch import graph as port_graph
from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu_torch.graph_align import GraphAligner
from gonomics_tpu_torch.io import giraf
from gonomics_tpu_torch.io.fasta import Fasta
from gonomics_tpu_torch.io.fastq import FastqBig
from gonomics_tpu_torch.io.vcf import Vcf
from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int32)
ASYMMETRIC = HUMAN_CHIMP_TWO.copy()
ASYMMETRIC[0, 1], ASYMMETRIC[1, 0] = 60, -400


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _batch(B: int, L: int, W: int, seed: int):
    """Anchored reads with SNPs and lowercase or '-.*' codes, short reads,
    short windows and junk rows."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    off = max(0, min(8, W - L))
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    take = min(L, W - off)
    reads[:, :take] = wins[:, off:off + take]
    reads[rng.random((B, L)) < 0.03] = rng.integers(0, 13)
    wins[rng.random((B, W)) < 0.01] = 4
    n_vec = np.where(rng.random(B) < 0.2, rng.integers(1, L + 1, B), L)
    m_vec = np.where(rng.random(B) < 0.2, rng.integers(1, W + 1, B), W)
    junk = rng.random(B) < 0.1
    reads[junk] = rng.integers(0, 4, (int(junk.sum()), L))
    return reads, wins, n_vec.astype(np.int32), m_vec.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,scoring", [
    (4096, 150, 198, "humanChimp"), (5, 40, 64, "plusMinusOne"),
    (37, 81, 129, "humanChimp"), (64, 81, 64, "plusMinusOne")])
def test_kernels_equal_plain(card, B, L, W, scoring):
    scores, gap = ((HUMAN_CHIMP_TWO, -600) if scoring == "humanChimp"
                   else (PLUS_MINUS_ONE, -1))
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, B + L)]
    sc = torch.as_tensor(scores, dtype=torch.int32, device=card)
    before = banded.dp_launches
    got = banded.banded_dp(*args, sc, gap)
    want = banded.banded_dp_reference(*args, sc, gap)
    torch.cuda.synchronize()
    assert banded.dp_launches == before + 1
    for name, g, w in zip(("bv", "bi", "trace"), got, want):
        assert torch.equal(g, w), name
    score = want[0].amax(1)
    walk = (want[2], want[1][:, 0], torch.zeros_like(score), score > 0,
            banded.walk_length(L))
    before = banded.walk_launches
    wgot = banded.banded_walk_pack(*walk)
    wwant = banded.banded_walk_pack_reference(*walk)
    torch.cuda.synchronize()
    assert banded.walk_launches == before + 1
    for name, g, w in zip(("i0", "c0", "packed"), wgot, wwant):
        assert torch.equal(g, w), name
    full = banded.banded_align_full(*args, sc, gap)
    cpu = banded.banded_align_full(*[a.cpu() for a in args], sc.cpu(), gap)
    for g, w in zip(full, cpu):
        assert torch.equal(g.cpu(), w)


def _scores(scoring: str, card):
    scores, gap = ((HUMAN_CHIMP_TWO, -600) if scoring == "humanChimp"
                   else (PLUS_MINUS_ONE, -1))
    return torch.as_tensor(scores, dtype=torch.int32, device=card), gap


@pytest.mark.cuda
@pytest.mark.parametrize("R", (2, 4, 8))
@pytest.mark.parametrize("B,L,W,scoring", [
    (4096, 150, 198, "humanChimp"), (1, 40, 64, "plusMinusOne"),
    (3, 150, 64, "humanChimp"), (37, 81, 129, "plusMinusOne")])
def test_banded_dp_each_lanes(card, R, B, L, W, scoring):
    """banded_dp's trace mode at each built R, forced, against its plain
    version; its plan as the library reports it; each launch counted."""
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, B + L + R)]
    sc, gap = _scores(scoring, card)
    plan = banded.banded_launch_plan(B, L, "dp", R)
    assert plan["lanes_per_thread"] == R and plan["spill_bytes"] == 0
    assert plan["threads"] == 32 * plan["warps_per_block"]
    before = banded.dp_launches
    got = banded._banded_launch(plan, *args, sc, gap)
    want = banded.banded_dp_reference(*args, sc, gap)
    torch.cuda.synchronize()
    assert banded.dp_launches == before + 1
    for name, g, w in zip(("bv", "bi", "trace"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("R", (None, 2, 4, 8))
@pytest.mark.parametrize("B,L,W,scoring", [
    (4096, 150, 198, "humanChimp"), (1, 40, 64, "plusMinusOne"),
    (3, 150, 64, "humanChimp"), (37, 81, 129, "plusMinusOne"),
    (37, 40, 88, "humanChimp")])
def test_fused_equals_plain(card, R, B, L, W, scoring):
    """The fused mode (plan's R, or each built R forced) against the plain
    banded_align_full, each launch counted; banded_align_full takes it."""
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, B * L + 1)]
    sc, gap = _scores(scoring, card)
    want = banded.banded_align_full_reference(*args, sc, gap)
    before = banded.fused_launches
    got = (banded.banded_align_fused(*args, sc, gap) if R is None else
           banded._banded_launch(banded.banded_launch_plan(B, L, "fused", R),
                                 *args, sc, gap))
    torch.cuda.synchronize()
    assert banded.fused_launches == before + 1
    names = ("score", "i_end", "j_end", "i0", "j0", "packed")
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), name
    if R is None:
        assert banded.banded_launch_plan(B, L)["mode"] == "fused"
        counts = (banded.dp_launches, banded.walk_launches)
        full = banded.banded_align_full(*args, sc, gap)
        torch.cuda.synchronize()
        assert banded.fused_launches == before + 2
        assert (banded.dp_launches, banded.walk_launches) == counts
        for g, w in zip(full, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_fused_at_forced_warps_and_unaligned_inputs(card):
    """The fused mode at 1 and 8 warps a block, and on views of the reads
    and windows that do not start on 16 bytes (the wrapper copies them)."""
    B, L, W = 300, 150, 198
    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(card)
                                 for x in _batch(B, L, W, 11))
    sc, gap = _scores("humanChimp", card)
    want = banded.banded_align_full_reference(reads, wins, n_vec, m_vec, sc,
                                              gap)
    for WB in (1, 8):
        plan = banded.banded_launch_plan(B, L, "fused", WB=WB)
        assert plan["warps_per_block"] == WB
        got = banded._banded_launch(plan, reads, wins, n_vec, m_vec, sc, gap)
        for g, w in zip(got, want):
            assert torch.equal(g, w), WB
    store_r = torch.zeros(B * L + 3, dtype=torch.int8, device=card)
    store_w = torch.zeros(B * W + 5, dtype=torch.int8, device=card)
    store_r[3:] = reads.reshape(-1)
    store_w[5:] = wins.reshape(-1)
    view_r, view_w = store_r[3:].view(B, L), store_w[5:].view(B, W)
    assert view_r.data_ptr() % 16 and view_w.data_ptr() % 16
    for g, w in zip(banded.banded_align_fused(view_r, view_w, n_vec, m_vec,
                                              sc, gap), want):
        assert torch.equal(g, w)
    for g, w in zip(banded.banded_dp(view_r, view_w, n_vec, m_vec, sc, gap),
                    banded.banded_dp_reference(reads, wins, n_vec, m_vec, sc,
                                               gap)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_long_reads_take_two_kernels(card):
    """Reads whose traces do not fit a block's shared memory: the plan is
    the trace mode, and banded_align_full launches banded_dp and
    banded_walk_pack, equal to the plain version."""
    B, L, W = 3, 13000, 13048
    assert banded.banded_launch_plan(B, L)["mode"] == "dp"
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, 5)]
    sc, gap = _scores("humanChimp", card)
    counts = (banded.dp_launches, banded.walk_launches, banded.fused_launches)
    got = banded.banded_align_full(*args, sc, gap)
    torch.cuda.synchronize()
    assert (banded.dp_launches, banded.walk_launches,
            banded.fused_launches) == (counts[0] + 1, counts[1] + 1,
                                       counts[2])
    want = banded.banded_align_full_reference(*args, sc, gap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        banded.banded_align_fused(*args, sc, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("R", (2, 4, 8))
@pytest.mark.parametrize("B,L,W,scoring", [
    (4096, 150, 198, "humanChimp"), (1, 40, 64, "plusMinusOne"),
    (3, 150, 64, "humanChimp"), (37, 81, 129, "plusMinusOne"),
    (5, 3000, 3048, "humanChimp")])
def test_banded_global_codes_equal_plain(card, R, B, L, W, scoring):
    """The trace mode's global-codes variant (the plan of reads whose
    staged codes do not fit a block's shared memory, about 116 kbp and
    up), forced at each R: banded_dp against its plain version, then
    banded_align_full's path (best_cell, banded_walk_pack) against
    banded_align_full_reference; its plan as the library reports it."""
    plan = banded.banded_launch_plan(B, L, "dp", R, codes="global")
    assert (plan["codes"], plan["lanes_per_thread"], plan["smem_bytes"],
            plan["spill_bytes"]) == ("global", R, 0, 0)
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, B + L + R)]
    sc, gap = _scores(scoring, card)

    def dp(*a):
        return banded._banded_launch(plan, *a)

    before = banded.dp_launches
    got = dp(*args, sc, gap)
    want = banded.banded_dp_reference(*args, sc, gap)
    torch.cuda.synchronize()
    assert banded.dp_launches == before + 1
    for name, g, w in zip(("bv", "bi", "trace"), got, want):
        assert torch.equal(g, w), name
    full = banded._align_full(dp, banded.banded_walk_pack, *args, sc, gap)
    for g, w in zip(full, banded.banded_align_full_reference(*args, sc,
                                                             gap)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_walk_on_random_traces(card):
    """banded_walk_pack's tile walk against the plain walk: random traces
    (codes 0-3, and mostly left or up moves that run past the band's
    columns) and traces of one code, from starts at i_end = L, i_end 0,
    columns 0 and 63 and random ones, active or not, over 1000 reads (not
    a multiple of the warps a block) and at the linear path's shape (4096
    reads of 150 bp), each launch counted; and from a view of the trace
    that is not 16-byte aligned."""
    rng = np.random.default_rng(3)
    for L, B in ((60, 1000), (150, 4096)):
        D = banded.walk_length(L)
        i_end = rng.integers(0, L + 1, B).astype(np.int32)
        c_end = rng.integers(0, 64, B).astype(np.int32)
        active = rng.random(B) < 0.8
        i_end[:4], c_end[:4], active[:4] = L, [0, 63, 0, 63], True
        i_end[4] = 0
        traces = [rng.choice(4, size=(L, B, 64), p=[0.6, 0.15, 0.15, 0.1]),
                  rng.choice(4, size=(L, B, 64), p=[0.3, 0.35, 0.34, 0.01])]
        traces += [np.full((L, B, 64), code) for code in (0, 1, 2)]
        for k, trace in enumerate(traces):
            args = [torch.from_numpy(x).to(card) for x in (
                trace.astype(np.int8), i_end, c_end, active)]
            want = banded.banded_walk_pack_reference(*args, D)
            before = banded.walk_launches
            got = banded.banded_walk_pack(*args, D)
            assert banded.walk_launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (L, k)
    # a view one byte into its storage: the wrapper copies it aligned
    flat = torch.from_numpy(traces[0].astype(np.int8).reshape(-1)).to(card)
    store = torch.zeros(flat.numel() + 1, dtype=torch.int8, device=card)
    store[1:] = flat
    view = store[1:].view(L, B, 64)
    assert view.data_ptr() % 16
    args = [torch.from_numpy(x).to(card) for x in (i_end, c_end, active)]
    for g, w in zip(banded.banded_walk_pack(view, *args, D),
                    banded.banded_walk_pack_reference(view, *args, D)):
        assert torch.equal(g, w)


def _pairs_batch(B: int, n: int, m: int, seed: int):
    """B pairs padded to (n, m): related pairs (SNPs, indels) of mixed
    lengths, N codes, a pair with an empty side and negative codes."""
    rng = np.random.default_rng(seed)
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    nb = rng.integers(max(1, n // 2), n + 1, B)
    mb = rng.integers(max(1, m // 2), m + 1, B)
    nb[0], mb[0] = n, m
    for b in range(B):
        a = rng.integers(0, 4, nb[b]).astype(np.int8)
        rel = np.concatenate([a[:nb[b] // 3], a[nb[b] // 3 + 2:],
                              rng.integers(0, 4, 3).astype(np.int8)])
        rel[rng.random(len(rel)) < 0.05] = 4
        rel = np.resize(rel, mb[b])
        alpha[b, :nb[b]] = a
        beta[b, :mb[b]] = rel
    if B > 2:
        nb[1] = 0
        alpha[1] = 4
        alpha[2, :min(n, 3)] = [-1, -7, 2][:n]
        beta[2, :min(m, 3)] = [-2, 1, -1][:m]
    return alpha, beta, (nb + mb).astype(np.int32)


_WAVEFRONT_CASES = [
    (mode, *shape) for mode in ("affine", "const") for shape in (
        (5, 37, 50, "humanChimp"), (3, 1, 1, "humanChimp"),
        (7, 90, 64, "plusMinusOne"), (129, 260, 301, "humanChimp"))]
# many strips a pair, over the most warps a pair
_WAVEFRONT_BIG = [("affine", 2, 5700, 40, "humanChimp"),
                  ("const", 2, 17100, 30, "plusMinusOne")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,B,n,m,scoring",
                         _WAVEFRONT_CASES + _WAVEFRONT_BIG)
def test_wavefront_kernels_equal_plain(card, mode, B, n, m, scoring):
    """K2 (trace mode: trace_diag; score mode: affine_score_diag) and K3
    (trace_diag in both modes) against their plain versions, whole
    tensors, with trace_diag's plan as its library reports it: the
    shape's rows a lane and warps a pair (8, the most, for the big
    cases), its block shape, and no spill."""
    big = (mode, B, n, m, scoring) in _WAVEFRONT_BIG
    scores, go, ge = ((HUMAN_CHIMP_TWO, -600, -150) if scoring == "humanChimp"
                      else (PLUS_MINUS_ONE, -1, -1))
    if mode == "const":
        go, ge = (-430 if scoring == "humanChimp" else -1), 0
    alpha, beta, fin = (torch.from_numpy(x).to(card)
                        for x in _pairs_batch(B, n, m, B + n))
    sc = torch.as_tensor(scores, dtype=torch.int32, device=card)
    counter = f"{mode}_launches"
    for with_trace in (True, False):
        on_trace_diag = with_trace or mode == "const"
        if on_trace_diag:
            kind = mode if with_trace else "const_score"
            plan = wavefront.trace_diag_launch_plan(B, n, m, kind)
            want_plan = wavefront.trace_diag_plan(
                B, n, m, kind, wavefront._trace_diag_built(kind))
            assert plan == {**plan, **want_plan}, plan
            assert (plan["warps_per_pair"] == 8) == big, plan
            assert plan["launch_blocks"] == plan["blocks"], plan
            assert plan["spill_bytes"] == 0, plan
        args = (alpha, beta, fin, sc)
        kw = dict(gap_open=go, gap_extend=ge, with_trace=with_trace,
                  mode=mode)
        before = getattr(wavefront, counter)
        kernel_before = wavefront.trace_diag_launches
        got = wavefront.wavefront_align(*args, **kw)
        want = (wavefront.affine_wavefront_reference(
                    *args, go, ge, with_trace) if mode == "affine" else
                wavefront.const_wavefront_reference(*args, go, with_trace))
        torch.cuda.synchronize()
        assert getattr(wavefront, counter) == before + 1
        assert wavefront.trace_diag_launches == kernel_before + on_trace_diag
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (with_trace, k)


# trace_diag's cases, (mode, B, n, m): K2's and K3's trace modes and K3's
# score mode on a ragged strip, m < n, n = 0 and one pair of 20,000 rows
# (157 strips at R = 4, 79 at R = 8), with fin_b of pair 0's own n_b x m_b
# and, for the pairs after it, past n + m, 0 and 1
_TRACE_DIAG_CASES = [
    (mode, *shape) for mode in ("affine", "const", "const_score")
    for shape in ((6, 300, 200), (5, 90, 70), (4, 600, 50), (3, 0, 7),
                  (1, 20_000, 300))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,B,n,m", _TRACE_DIAG_CASES)
def test_trace_diag_each_plan(card, mode, B, n, m):
    """trace_diag at every rows a lane it is built for in the mode and at
    1, 2, 3 and
    its most warps a pair (8: one warp a strip in turn, strips pipelined
    over warps, more warps than strips), against the plain versions on
    whole tensors, with the launch its library reports: the plan's block
    shape and no spill."""
    alpha, beta, fin = _pairs_batch(B, max(n, 1), m, B + n + m)
    alpha = np.ascontiguousarray(alpha[:, :n])
    if n == 0:
        fin = np.minimum(fin, m)
    edges = [n + m + 1, 0, 1][:max(B - 1, 0)]
    fin[1:1 + len(edges)] = edges
    args = [torch.from_numpy(x).to(card) for x in (alpha, beta, fin)]
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    go, ge = (-600, -150) if mode == "affine" else (-430, 0)
    if mode == "affine":
        want = wavefront.affine_wavefront_reference(*args, sc, go, ge, True)
    else:
        want = wavefront.const_wavefront_reference(*args, sc, go,
                                                   mode == "const")
    want = want if isinstance(want, tuple) else (want,)
    built = wavefront._trace_diag_built(mode)
    for R in built["rows_per_lane"]:
        for W in (1, 2, 3, built["max_warps"]):
            plan = wavefront.trace_diag_launch_plan(B, n, m, mode, R, W)
            assert plan["threads"] == 32 * plan["warps_per_block"], plan
            assert plan["launch_blocks"] == plan["blocks"], plan
            assert plan["spill_bytes"] == 0, plan
            res = [torch.empty_like(want[0])
                   for _ in range(3 if mode == "affine" else 1)]
            before = wavefront.trace_diag_launches
            trace = wavefront._trace_diag_launch(mode, *args, sc, go, ge,
                                                 plan, res)
            torch.cuda.synchronize()
            assert wavefront.trace_diag_launches == before + 1
            got = res + ([trace] if trace is not None else [])
            assert len(got) == len(want)
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (R, W, k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["affine", "const"])
def test_pairwise_on_card_equals_cpu(card, mode):
    """The batch API on the card against device="cpu": scores and
    routes, for pairs with N codes, an empty alpha and reversed
    relatives."""
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(9):
        a = rng.integers(0, 5, int(rng.integers(0, 120))).astype(np.int8)
        pairs.append((a, np.resize(a[::-1], int(rng.integers(1, 111)))))
    pairs.append((np.zeros(0, np.int8), np.array([0, 1, 2], np.int8)))

    def run(device):
        if mode == "affine":
            out = align.affine_gap_batch(pairs, HUMAN_CHIMP_TWO, -600, -150,
                                         device=device)
        else:
            out = align.const_gap_batch(pairs, HUMAN_CHIMP_TWO, -430,
                                        device=device)
        return [(s, [(c.run_length, c.op) for c in r]) for s, r in out]

    assert run(card) == run("cpu")


def _graph_jobs(C: int, n: int, m: int, seed: int):
    """C graph-aligner jobs padded to (n, m): genome windows and read
    parts copied from their ends (left jobs) or starts (right jobs) with
    SNPs, random read parts, N codes, and jobs with an empty window, an
    empty read part or both."""
    rng = np.random.default_rng(seed)
    al = np.full((C, n), 4, np.int8)
    be = np.full((C, m), 4, np.int8)
    nv = rng.integers(1, n + 1, C)
    mv = rng.integers(1, m + 1, C)
    nv[-1], mv[-1] = n, m
    for b in range(C):
        win = rng.integers(0, 4, nv[b]).astype(np.int8)
        al[b, :nv[b]] = win
        k = min(nv[b], mv[b])
        part = rng.integers(0, 4, mv[b]).astype(np.int8)
        if b % 3 == 1:
            part[-k:] = win[-k:]
        elif b % 3 == 2:
            part[:k] = win[:k]
        part[rng.random(mv[b]) < 0.03] = rng.integers(0, 5)
        be[b, :mv[b]] = part
    nv[0] = 0
    mv[1] = 0
    nv[2] = mv[2] = 0
    return al, be, nv.astype(np.int32), mv.astype(np.int32)


# (C, n, m, scoring, (design, slots a lane, state)) of graph_dp_plan,
# the same for both kernels unless a dict by mode
_GRAPH_CASES = [
    (2048, 192, 192, "humanChimp", ("warp", 8, "registers")),
    (7, 40, 33, "plusMinusOne", ("warp", 2, "registers")),
    (5, 2048, 150, "humanChimp", ("warp", 5, "registers")),
    (64, 100, 70, "asymmetric", ("warp", 3, "registers")),
    (5, 10300, 32, "humanChimp", ("warp", 2, "registers")),
    # the warp design's reach, m + 1 = 32 x 16, and one above it
    (6, 300, 511, "humanChimp", ("warp", 16, "registers")),
    (6, 300, 512, "asymmetric", ("block", 0, "shared")),
    # the block design with its state in a global scratch
    (5, 10300, 600, "humanChimp", ("block", 0, "global")),
    (5, 9000, 600, "plusMinusOne",
     {"local": ("block", 0, "global"), "gsw_right": ("block", 0, "shared")}),
]


def _graph_plan_of(C, n, m, mode):
    """graph_dp_plan's design, with its launch as the library reports it
    checked: a warp a job, or a block a job of at most 512 threads that
    covers the window's lanes or strides over them."""
    plan = wavefront.graph_dp_plan(C, n, m, mode)
    assert plan["threads"] == 32 * plan["warps_per_block"]
    if plan["design"] == "warp":
        per = plan["warps_per_block"]
        assert (plan["blocks"] - 1) * per < C <= plan["blocks"] * per
    else:
        assert plan["blocks"] == C
        assert plan["threads"] == min(512, -(-(n + 1) // 32) * 32)
    return plan["design"], plan["slots_per_lane"], plan["state"]


@pytest.mark.cuda
@pytest.mark.parametrize("C,n,m,scoring,plan", _GRAPH_CASES)
def test_graph_kernels_equal_plain(card, C, n, m, scoring, plan):
    """local_wavefront (K4), gsw_right_wavefront (K5) and gsw_walk_pack,
    both sides, against their plain versions, at the plan each case
    should take: the warp design at the main shape (192 x 128 on the
    main path), at n = 2048, at the 10,300-base window and at its reach
    m = 511; the block design one above it
    and with its state in a global scratch (n above 8,532 for K4, above
    10,239 for K5)."""
    for mode in ("local", "gsw_right"):
        want_plan = plan[mode] if isinstance(plan, dict) else plan
        assert _graph_plan_of(C, n, m, mode) == want_plan, mode
    scores, gap = {"humanChimp": (HUMAN_CHIMP_TWO, -600),
                   "plusMinusOne": (PLUS_MINUS_ONE, -1),
                   "asymmetric": (ASYMMETRIC, -300)}[scoring]
    al, be, nv, mv = (torch.from_numpy(x).to(card)
                      for x in _graph_jobs(C, n, m, C + n))
    sc = torch.as_tensor(scores, dtype=torch.int32, device=card)
    args = (al, be, nv, mv, sc, gap)
    for with_corner in (False, True):
        before = wavefront.local_launches
        got = wavefront.local_wavefront(*args, with_corner=with_corner)
        want = wavefront.local_wavefront_reference(*args, with_corner)
        torch.cuda.synchronize()
        assert wavefront.local_launches == before + 1
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (with_corner, k)
    _, _, ltrace, corner = want
    before = wavefront.gsw_right_launches
    right = wavefront.gsw_right_wavefront(*args)
    rwant = wavefront.gsw_right_wavefront_reference(*args)
    torch.cuda.synchronize()
    assert wavefront.gsw_right_launches == before + 1
    for k, (g, w) in enumerate(zip(right, rwant)):
        assert torch.equal(g, w), ("right", k)
    bv, bd, rtrace = rwant
    scored = 0
    for side, walk in (("left", (ltrace, corner, None, nv, mv)),
                       ("right", (rtrace, bv, bd))):
        before = gsw_dp.walk_launches
        got = gsw_dp.gsw_walk_pack(side, *walk)
        want = gsw_dp.gsw_walk_pack_reference(side, *walk)
        torch.cuda.synchronize()
        assert gsw_dp.walk_launches == before + 1
        assert torch.equal(got, want), side
        meta = want[:, :12].cpu().numpy().copy().view(np.int32)
        scored += int((meta[3:, 0] > 0).sum())
    assert scored > 0  # real alignments were walked


def _junk_walk_inputs(D: int, C: int, S: int, seed: int):
    """Random traces and starts for both sides of gsw_walk_pack: codes 0-3
    everywhere (right walks stall on a 3 or clamp at i = 0 or j = 0
    without moving; left walks stop), left starts at lane 0, at S - 1, on
    diagonal 1, past the trace's last row and lane, on the allocation's
    last row, with a score <= 0; right bests with a max <= 0, ties (the
    first lane wins), starts at lanes 0 and S - 1, at j = 0, on diagonal 0
    and with j < 0."""
    rng = np.random.default_rng(seed)
    n = S - 1
    trace = rng.choice(4, size=(D, C, S), p=[0.55, 0.2, 0.2, 0.05])
    nv = rng.integers(1, n + 1, C).astype(np.int32)
    mv = rng.integers(1, D - n + 1, C).astype(np.int32)
    corner = rng.integers(-5, 60, (C, S)).astype(np.int32)
    nv[0], mv[0] = n, D - n
    nv[1], mv[1] = 1, 1
    nv[2], mv[2] = n + 5, D
    nv[3] = 0
    nv[-1], mv[-1] = n, D - n
    corner[4, nv[4]] = 0
    bv = rng.integers(-20, 40, (C, S)).astype(np.int32)
    bd = (np.arange(S)[None, :]
          + rng.integers(-3, D - n + 2, (C, S))).astype(np.int32)
    bv[0] = -1
    bv[1] = 0
    bv[2, :] = 7
    bv[3, :] = 1
    bv[3, S - 1] = 9
    bv[4, :] = 1
    bv[4, 5], bd[4, 5] = 9, 5
    bv[5, :] = 1
    bv[5, 0], bd[5, 0] = 9, 1
    bd[6] = np.arange(S) - 2
    return trace.astype(np.int8), nv, mv, corner, bv, bd


@pytest.mark.cuda
@pytest.mark.parametrize("D,C,S", [(320, 2048, 193), (67, 9, 40),
                                   (131, 13, 71), (551, 8, 301), (9, 8, 6)])
def test_graph_walk_tiles_on_junk_traces(card, D, C, S):
    """gsw_walk_pack, its three sides, each launch counted (the local
    side, local_align_full's walk, in local_walk_launches), against the
    plain walk on random traces from `_junk_walk_inputs` and on traces of
    one code (walks that leave their tiles through each edge): the graph
    path's wave (2048 jobs at (n, m) = (192, 128)), the CPU emulation's
    shapes (D not a multiple of 4, C not a multiple of the warps a block,
    D past 512 steps), and a window narrower than the tile (S = 6: every
    load byte by byte). The local side starts from the right side's
    bests."""
    trace, nv, mv, corner, bv, bd = _junk_walk_inputs(D, C, S, D + C)
    traces = [trace] + [np.full((D, C, S), code, np.int8)
                        for code in (0, 1, 2)]
    starts = [torch.from_numpy(x).to(card) for x in (nv, mv, corner, bv, bd)]
    nv, mv, corner, bv, bd = starts
    for k, tr in enumerate(traces):
        tr = torch.from_numpy(tr).to(card)
        for side, walk in (("left", (tr, corner, None, nv, mv)),
                           ("right", (tr, bv, bd, None, None)),
                           ("local", (tr, bv, bd, None, None))):
            want = gsw_dp.gsw_walk_pack_reference(side, *walk)
            before = (gsw_dp.walk_launches, gsw_dp.local_walk_launches)
            assert torch.equal(gsw_dp.gsw_walk_pack(side, *walk), want), (
                k, side)
            local = side == "local"
            assert (gsw_dp.walk_launches, gsw_dp.local_walk_launches) == (
                before[0] + (not local), before[1] + local)


@pytest.mark.cuda
def test_graph_walk_tiles_on_real_traces(card):
    """gsw_walk_pack against the plain walk on the plain DPs' traces of
    2048 jobs at (192, 128), the graph path's wave, and of 13 jobs at (70,
    61)."""
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    for C, n, m in ((2048, 192, 128), (13, 70, 61)):
        jobs = [torch.from_numpy(x).to(card)
                for x in _graph_jobs(C, n, m, C + n)]
        _, _, ltrace, corner = wavefront.local_wavefront_reference(
            *jobs, sc, -600, True)
        bv, bd, rtrace = wavefront.gsw_right_wavefront_reference(*jobs, sc,
                                                                 -600)
        for side, walk in (("left", (ltrace, corner, None, *jobs[2:])),
                           ("right", (rtrace, bv, bd, None, None))):
            want = gsw_dp.gsw_walk_pack_reference(side, *walk)
            assert torch.equal(gsw_dp.gsw_walk_pack(side, *walk), want), (
                C, side)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,scoring", [
    (4096, 150, 198, "humanChimp"), (13, 70, 118, "plusMinusOne"),
    (37, 81, 129, "humanChimp"), (5, 300, 348, "humanChimp")])
def test_local_align_full_equals_plain(card, B, L, W, scoring):
    """local_align_full, the read aligner's mesh path (K4 over the whole
    (L, W) grid, then the walk's local side), against its plain version
    on anchored reads: the mesh path's shape (4096 reads of 150 bp in
    198 bp windows, K4's warp design at 8 slots a lane) and others; one
    launch of each kernel; the walk also on the plain DP's trace."""
    args = [torch.from_numpy(x).to(card) for x in _batch(B, L, W, B + W)]
    sc, gap = _scores(scoring, card)
    counts = (wavefront.local_launches, gsw_dp.local_walk_launches)
    got = wavefront.local_align_full(*args, sc, gap)
    want = wavefront.local_align_full_reference(*args, sc, gap)
    torch.cuda.synchronize()
    assert (wavefront.local_launches,
            gsw_dp.local_walk_launches) == (counts[0] + 1, counts[1] + 1)
    for name, g, w in zip(("score", "i_end", "j_end", "i0", "j0", "packed"),
                          got, want):
        assert torch.equal(g, w), name
    assert int((want[0] > 0).sum()) > B // 2
    bv, bd, trace = wavefront.local_wavefront_reference(*args, sc, gap)
    assert torch.equal(gsw_dp.gsw_walk_pack("local", trace, bv, bd),
                       gsw_dp.gsw_walk_pack_reference("local", trace, bv,
                                                      bd))


@pytest.mark.cuda
def test_read_aligner_mesh_on_card_equals_cpu(card):
    """ReadAligner on a mesh of two data slices on the one card (the
    device repeated) gives the SAM of the mesh path on the CPU and of a
    mesh of one slice, launching K4 and the local walk once a slice."""
    from gonomics_tpu_torch.io.fastq import Fastq
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 200_000).astype(np.int8)
    reads = []
    for i in range(301):
        s = int(rng.integers(0, len(genome) - 100))
        seq = genome[s:s + 100].copy()
        seq[int(rng.integers(0, 100))] ^= 1
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(Fastq(f"r{i}", seq, np.full(100, 30, np.uint8)))
    cpu = ReadAligner([Fasta("chr1", genome)], device="cpu",
                      mesh=make_mesh(devices=["cpu"], data=1))
    want = cpu.finish_batch_lines(cpu.align_batch_async(reads))
    for data in (1, 2):
        al = ReadAligner.from_state(
            cpu.state(), mesh=make_mesh(devices=[card] * data, data=data))
        assert al.device == torch.device("cuda", card.index or 0)
        counts = (wavefront.local_launches, gsw_dp.local_walk_launches)
        got = al.finish_batch_lines(al.align_batch_async(reads))
        assert got == want, data
        assert (wavefront.local_launches - counts[0],
                gsw_dp.local_walk_launches - counts[1]) == (data, data)
    assert want.count("\tchr1\t") > 290


def _mesh_reads(genome, n: int, L: int, seed: int):
    """n reads of L bp with a SNP each, every other one reverse-
    complemented."""
    from gonomics_tpu_torch.io.fastq import Fastq

    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - L))
        seq = genome[s:s + L].copy()
        seq[int(rng.integers(0, L))] ^= 1
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(Fastq(f"r{i}", seq, np.full(L, 30, np.uint8)))
    return reads


@pytest.mark.cuda
def test_prefix_lookup_on_card_equals_cpu(card):
    """shard_seed_lookup over 4 chunks on the one card equals the same
    lookup over 4 chunks on the CPU, queries at every chunk's edges, the
    pad and bad-window codes and a run past max_hits among them."""
    from gonomics_tpu_torch import parallel
    from gonomics_tpu_torch.read_align import (_PAD_CODE, build_seed_index,
                                               split_index_prefix)

    rng = np.random.default_rng(12)
    unit = rng.integers(0, 4, 30).astype(np.int8)
    genome = np.concatenate([np.tile(unit, 40),
                             rng.integers(0, 4, 300_000).astype(np.int8)])
    codes, pos = build_seed_index(genome, 21)
    ck, ps = split_index_prefix(codes, pos, 4)
    edges = [row[row != _PAD_CODE][[0, -1]] for row in ck]
    q = np.concatenate([*edges, [_PAD_CODE, np.uint64(1) << np.uint64(62)],
                        rng.choice(codes, 4086),
                        rng.integers(0, 1 << 42, 4096).astype(np.uint64)])
    q = q.astype(np.uint64).reshape(-1, 8)
    got = []
    for devices in ([card] * 4, ["cpu"] * 4):
        mesh = parallel.make_mesh(devices=devices, data=4)
        keys, cpos = parallel.place_index_chunks(mesh, ck, ps)
        assert all(k.device == mesh.devices[0][0] for k in keys)
        hp, valid = parallel.shard_seed_lookup(mesh, max_hits=8)(
            keys, cpos, parallel.code_keys(q))
        got.append((hp.cpu(), valid.cpu()))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    assert int(got[0][1].sum(dim=2).max()) == 8


@pytest.mark.cuda
def test_prefix_aligner_on_card_equals_replicated(card):
    """ReadAligner(index_sharding="prefix") on a mesh of four data slices
    on the one card gives the SAM of the replicated index on a mesh of
    one, single reads and pairs, launching K4 and the local walk once a
    slice."""
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 500_000).astype(np.int8)
    reads = _mesh_reads(genome, 402, 120, 13)
    repl = ReadAligner([Fasta("chr1", genome)], mesh=make_mesh(
        devices=[card], data=1))
    pref = ReadAligner.from_state(
        repl.state(), mesh=make_mesh(devices=[card] * 4, data=4),
        index_sharding="prefix")
    want = repl.finish_batch_lines(repl.align_batch_async(reads))
    counts = (wavefront.local_launches, gsw_dp.local_walk_launches)
    got = pref.finish_batch_lines(pref.align_batch_async(reads))
    assert (wavefront.local_launches - counts[0],
            gsw_dp.local_walk_launches - counts[1]) == (4, 4)
    assert got == want
    assert want.count("\tchr1\t") > 395
    pairs = list(zip(reads[0::2], reads[1::2]))
    assert [s.to_string() for s in pref.align_pairs(pairs)] == [
        s.to_string() for s in repl.align_pairs(pairs)]


@pytest.mark.cuda
def test_multihost_on_card(card, tmp_path):
    """gsw align --multihost in two processes on the one card (gloo over
    loopback), with and without --index-sharding prefix: the merged SAM
    is byte-identical to one process's --mesh output."""
    import os
    import socket
    import subprocess
    import sys

    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io.fastq import qual_string

    rng = np.random.default_rng(14)
    genome = rng.integers(0, 4, 400_000).astype(np.int8)
    ref, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    s = dna.to_string(genome)
    ref.write_text(">chrM\n" + "".join(s[i:i + 60] + "\n"
                                       for i in range(0, len(s), 60)))
    fq.write_text("".join(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                          f"{qual_string(r.qual)}\n"
                          for r in _mesh_reads(genome, 1000, 150, 14)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for extra in ([], ["--index-sharding", "prefix"]):
        flags = ["--engine", "tpu", "--batch", "256", *extra]
        one = tmp_path / "one.sam"
        gsw_cmd.main(["align", str(ref), str(fq), "-o", str(one), *flags,
                      "--mesh"])
        merged = tmp_path / "merged.sam"
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = str(sock.getsockname()[1])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gonomics_tpu_torch.cli.gsw_cmd", "align",
             str(ref), str(fq), "-o", str(merged), *flags, "--multihost"],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
            for r in range(2)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert [p.returncode for p in procs] == [0, 0], errs
        assert merged.read_bytes() == one.read_bytes(), extra
        assert one.read_text().count("\tchrM\t") > 990


@pytest.mark.cuda
def test_graph_warp_slots(card):
    """The warp design at every count of slots a lane it is built for that
    holds the job's slots, exactly equal to the plain versions; too few
    slots for the read part is refused by the launch (it raises). The
    library reports the slots the CPU tests assume."""
    C, n, m = 37, 150, 40
    al, be, nv, mv = (torch.from_numpy(x).to(card)
                      for x in _graph_jobs(C, n, m, 99))
    sc = torch.as_tensor(ASYMMETRIC, dtype=torch.int32, device=card)
    args = (al, be, nv, mv, sc, -300)
    lwant = wavefront.local_wavefront_reference(*args, True)
    rwant = wavefront.gsw_right_wavefront_reference(*args)
    slots = wavefront._graph_built()["slots"]
    assert slots == (1, 2, 3, 4, 5, 6, 8, 12, 16)
    base = wavefront.graph_dp_plan(C, n, m, "local")
    assert base["slots_per_lane"] == 2
    for L in slots[1:]:
        plan = {**base, "slots_per_lane": L}
        lgot = wavefront._graph_launch("local", al, be, nv, mv, sc, -300,
                                       True, plan)
        rgot = wavefront._graph_launch("gsw_right", al, be, nv, mv, sc,
                                       -300, False, plan)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(lgot, lwant)):
            assert torch.equal(g, w), ("local", L, k)
        for k, (g, w) in enumerate(zip(rgot, rwant)):
            assert torch.equal(g, w), ("right", L, k)
    with pytest.raises(RuntimeError, match="local_wavefront"):
        wavefront._graph_launch("local", al, be, nv, mv, sc, -300, True,
                                {**base, "slots_per_lane": 1})


@pytest.mark.cuda
def test_graph_aligner_on_card_equals_cpu(card):
    """GraphAligner on the card against device="cpu" on a variant graph
    with SNP, DEL and INS nodes: giraf text equal, single and paired."""
    rng = np.random.default_rng(12)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    vcfs = [Vcf(chrom="chr1", pos=p, id=".", ref=dna.to_string(ref[p - 1:p]),
                alt=[dna.to_string((ref[p - 1:p] + 1) % 4)],
                info="SVTYPE=SNP") for p in (400, 1200, 2500)]
    vcfs.append(Vcf(chrom="chr1", pos=1800, id=".",
                    ref=dna.to_string(ref[1799:1804]),
                    alt=[dna.to_string(ref[1799:1800])], info="SVTYPE=DEL"))
    g = port_graph.variant_graph([Fasta("chr1", ref)], {"chr1": vcfs})
    reads = []
    for i in range(40):
        s = int(rng.integers(0, len(ref) - 150))
        seq = ref[s:s + 150].copy()
        seq[int(rng.integers(0, 150))] = (seq[0] + 1) % 4
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(FastqBig(f"r{i}", seq,
                              dna.reverse_complement(seq).astype(np.int8),
                              np.full(150, 30, np.uint8)))
    on_card = GraphAligner(g, device=card)
    on_cpu = GraphAligner(g, device="cpu")
    assert [giraf.to_string(x) for x in on_card.align_batch(reads)] == \
        [giraf.to_string(x) for x in on_cpu.align_batch(reads)]
    pairs = list(zip(reads[0::2], reads[1::2]))
    assert [[giraf.to_string(x) for x in p]
            for p in on_card.align_pair_batch(pairs)] == \
        [[giraf.to_string(x) for x in p]
         for p in on_cpu.align_pair_batch(pairs)]


def _lowmem_pairs(B: int, n: int, m: int, seed: int):
    """B pairs of n x m: relatives of their alphas (a gap, SNPs, N codes),
    one random pair, and negative codes."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 4, (B, n)).astype(np.int8)
    beta = np.empty((B, m), np.int8)
    for b in range(B):
        rel = np.resize(np.concatenate([alpha[b, :n // 3],
                                        alpha[b, n // 3 + 3:]]), m)
        rel[rng.random(m) < 0.04] = rng.integers(0, 5)
        beta[b] = rel
    beta[-1] = rng.integers(0, 4, m)
    alpha[0, rng.integers(0, n, 2)] = [-1, 4]
    beta[0, rng.integers(0, m, 2)] = [-2, 4]
    return alpha, beta


# (B, n, m, K, scoring): the window moving and clipped (W = 768 < S), n = 1,
# m = 1, a single block, and K = 4096 with n = 9000, where the backward
# window (W = 8832) needs 4 lanes a thread over a cluster of 8 and the
# forward splits the 9001 lanes over a cluster
_LOWMEM_CASES = [(3, 900, 300, 8, "humanChimp"), (2, 1, 40, 16, "humanChimp"),
                 (2, 40, 1, 16, "plusMinusOne"), (3, 50, 30, 128, "humanChimp"),
                 (2, 9000, 300, 4096, "humanChimp")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,K,scoring", _LOWMEM_CASES)
def test_lowmem_kernels_equal_plain(card, B, n, m, K, scoring):
    """affine_fwd_block (K6) on every forward block, then affine_bwd_window
    (K7) and lowmem_walk_block on every block of the backward, each
    against its plain version from the same inputs."""
    scores, go, ge = ((HUMAN_CHIMP_TWO, -600, -150) if scoring == "humanChimp"
                      else (PLUS_MINUS_ONE, -1, -1))
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _lowmem_pairs(B, n, m, B + n))
    sc = torch.as_tensor(scores, dtype=torch.int32, device=card)
    W = wavefront.window_width(n, K)
    big = n == 9000
    plan = wavefront.fwd_block_plan(B, n, card)
    assert plan["cluster"] == (8 if big else 1)
    assert plan["state_in_shared_memory"]
    assert wavefront.state_in_shared_memory(W - 1, "affine") == (not big)
    before = wavefront.affine_fwd_block_launches
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)
    nb = ck.shape[0]
    assert wavefront.affine_fwd_block_launches == before + nb
    for blk in range(nb):
        want = wavefront.affine_fwd_block_reference(alpha, beta, ck[blk],
                                                    blk * K, n + m, sc, go, ge,
                                                    K)
        if blk + 1 < nb:
            assert torch.equal(ck[blk + 1], want[0]), blk
        got = wavefront.affine_fwd_block(alpha, beta, ck[blk], blk * K, n + m,
                                         sc, go, ge, K)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), blk
    assert torch.equal(cap, want[1])
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((B,), n, dtype=torch.int32, device=card)
    j = torch.full((B,), m, dtype=torch.int32, device=card)
    moved = set()
    for blk in reversed(range(nb)):
        d0 = blk * K
        before = (wavefront.affine_bwd_window_launches,
                  wavefront.lowmem_walk_launches)
        trace, wlo = wavefront.affine_bwd_window(alpha, beta, ck[blk], d0, i,
                                                 sc, go, ge, K)
        wtrace, wwlo = wavefront.affine_bwd_window_reference(
            alpha, beta, ck[blk], d0, i, sc, go, ge, K)
        torch.cuda.synchronize()
        assert torch.equal(wlo, wwlo) and torch.equal(trace, wtrace), blk
        moved.update(wlo.tolist())
        ii, jj, kk = i.clone(), j.clone(), k.clone()
        ops = wavefront.lowmem_walk_block(trace, wlo, d0, i, j, k)
        wops = wavefront.lowmem_walk_block_reference(trace, wlo, d0, ii, jj,
                                                     kk)
        torch.cuda.synchronize()
        assert (wavefront.affine_bwd_window_launches,
                wavefront.lowmem_walk_launches) == (before[0] + 1,
                                                    before[1] + 1)
        assert torch.equal(ops, wops), blk
        for g, w in ((i, ii), (j, jj), (k, kk)):
            assert torch.equal(g, w), blk
    assert bool(((i == 0) | (j == 0)).all())
    if W < n + 1:
        assert len(moved) > 1  # the window moved


# (B, n, m, K, CL): affine_fwd_block with clusters of CL blocks forced, at
# its edges: S = 1001 lanes not a multiple of CL; n = 1, n = 10 and n = 12
# (clusters of 5), where blocks 1-7, 5-7 and 4 have empty lane ranges;
# clusters of 7 with a shorter last block; 80 pairs of clusters of 8 at
# 1,025 lanes a block, more than the card holds at once (the clusters run
# in waves); and 6,000 lanes a block, whose state is above the
# shared-memory limit (global scratch), with clusters of 2 and of 1 (what
# the wrapper picks when more pairs than the card holds clusters of 2
# each keep more than ~5,700 lanes). In every case n + m is not a
# multiple of K, so the diagonal fin = n + m lies inside the last block.
_FWD_CLUSTER_CASES = [(3, 1000, 300, 96, 8), (2, 1, 40, 16, 8),
                      (3, 10, 37, 8, 8), (2, 12, 30, 8, 5),
                      (2, 5000, 100, 1024, 7), (80, 8200, 200, 2048, 8),
                      (2, 12000, 100, 4096, 2), (2, 6000, 100, 4096, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,K,CL", _FWD_CLUSTER_CASES)
def test_fwd_block_cluster_edges(card, B, n, m, K, CL):
    """affine_fwd_block's cluster kernel on every block of the forward,
    exact against its plain version (the checkpoint and the capture)."""
    assert (n + m) % K
    lanes = wavefront.fwd_block_lanes(n, CL)
    assert wavefront.state_in_shared_memory(lanes, "affine") == (lanes < 6000)
    if B == 80:
        assert B > wavefront._fwd_config(CL, n, card)[0]
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _lowmem_pairs(B, n, m, B + n))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    state = wavefront.initial_state(B, n, -600, card)
    nb = (n + m - 1) // K + 1
    before = wavefront.affine_fwd_block_launches
    for blk in range(nb):
        got = wavefront._fwd_block_launch(alpha, beta, state, blk * K, n + m,
                                          sc, -600, -150, K, CL)
        want = wavefront.affine_fwd_block_reference(
            alpha, beta, state, blk * K, n + m, sc, -600, -150, K)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), blk
        state = want[0]
    assert wavefront.affine_fwd_block_launches == before + nb
    assert int(want[1][0, :, n].max()) > -(1 << 30)  # fin was captured


# (B, n, m, K, CL, L): affine_bwd_window with clusters of CL blocks at L
# lanes a thread forced, on every block of a backward: a moving window of
# 768 lanes (n = 900, K = 8) that starts clipped at S - W and reaches 0,
# at CL = 1, 2 and 8 (the largest the card allows; 12 strips of 64 lanes,
# 2 a block, the last two blocks without one) and at 4 and 8 lanes a
# thread; a window of 701 lanes (W = S, n = 700, K = 256), not a multiple
# of a strip; n = 40 (W = S = 41, one strip) at CL = 1 and at CL = 2,
# whose second block has no strip; m = 1; the 100 kb pair's K = 4096 at W
# = 8,832 lanes (n = 9,000) at CL = 8 and 4 lanes a thread, and at CL = 3
# and 8 lanes a thread (12 strips a block); with B = None, more pairs
# than the card holds clusters of 8 at once (the clusters run in waves);
# windows the blocks sweep in passes, the edge between two passes in
# global memory: bench.py's 2,688 lanes (K = 1024) at CL = 1 (42 strips,
# 16 a block, 3 passes) and at CL = 2 (2 passes, the second block without
# a strip in the last), and a window of 33,408 lanes (K = 16,384, n =
# 34,000), wider than 8 blocks of 16 strips of 8 lanes cover, at the plan
_BWD_CLUSTER_CASES = [(3, 900, 300, 8, 1, 2), (3, 900, 300, 8, 2, 2),
                      (3, 900, 300, 8, 8, 2), (3, 900, 300, 8, 2, 4),
                      (2, 900, 300, 8, 1, 8), (3, 700, 90, 256, 3, 2),
                      (2, 40, 300, 16, 1, 2), (2, 40, 300, 16, 2, 2),
                      (2, 50, 1, 16, 1, 2), (1, 9000, 300, 4096, 8, 4),
                      (1, 9000, 300, 4096, 3, 8), (None, 900, 300, 64, 8, 2),
                      (2, 3000, 300, 1024, 1, 2), (2, 3000, 300, 1024, 2, 2),
                      (1, 34000, 300, 16384, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,K,CL,L", _BWD_CLUSTER_CASES)
def test_bwd_window_cluster_edges(card, B, n, m, K, CL, L):
    """affine_bwd_window at forced cluster sizes and lanes a thread on
    every block of a backward, from the forward's checkpoints and the
    walk's rows: every byte of the trace and every window start exactly
    equal to the plain version's."""
    W = wavefront.window_width(n, K)
    if CL is None:
        plan = wavefront.bwd_window_plan(B, n, K, card)
        CL, L = plan["cluster"], plan["lanes_per_thread"]
        assert plan["passes"] > 1
    resident = wavefront._bwd_config(W, CL, L, card)[0]
    if B is None:
        B = resident + 3
    assert B <= resident or B == resident + 3
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _lowmem_pairs(B, n, m, B + n))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, -600, -150, K)
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((B,), n, dtype=torch.int32, device=card)
    j = torch.full((B,), m, dtype=torch.int32, device=card)
    starts = set()
    before = wavefront.affine_bwd_window_launches
    nb = ck.shape[0]
    for blk in reversed(range(nb)):
        d0 = blk * K
        got = wavefront._bwd_window_launch(alpha, beta, ck[blk], d0, i, sc,
                                           -600, -150, K, CL, L)
        want = wavefront.affine_bwd_window_reference(alpha, beta, ck[blk], d0,
                                                     i, sc, -600, -150, K)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), blk
        assert torch.equal(got[0], want[0]), blk
        starts.update(want[1].tolist())
        wavefront.lowmem_walk_block_reference(*want, d0, i, j, k)
    assert wavefront.affine_bwd_window_launches == before + nb
    assert bool(((i == 0) | (j == 0)).all())
    if W < n + 1:
        assert {0, n + 1 - W} <= starts  # clipped at S - W, and at 0


@pytest.mark.cuda
def test_bwd_window_repeats(card):
    """The main path's plan on 16 pairs of 3,000 x 3,000 at K = 1024
    (W = 2,688, the full-width window), 200 launches of one block: the
    strips' rings and counters are reused each launch, and every launch
    must give the same trace."""
    B, n, K = 16, 3000, 1024
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _lowmem_pairs(B, n, n, 7))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    ck, _ = wavefront.lowmem_forward(alpha, beta, sc, -600, -150, K)
    d0 = 2 * K
    i = torch.full((B,), n, dtype=torch.int32, device=card)
    i -= torch.arange(B, dtype=torch.int32, device=card) * 37
    want = wavefront.affine_bwd_window_reference(alpha, beta, ck[2], d0, i,
                                                 sc, -600, -150, K)
    plan = wavefront.bwd_window_plan(B, n, K, card)
    assert plan["window_lanes"] == 2688 and plan["cluster"] > 1
    for _ in range(200):
        got = wavefront.affine_bwd_window(alpha, beta, ck[2], d0, i, sc, -600,
                                          -150, K)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _walk_cases(rng):
    """(trace, wlo, d0, i, j, k) cases for the walk: random codes (the
    unknown state 3 included) from cells on the block, before it and on
    row 0 or column 0; then B = 301 walks (not a multiple of the warps a
    block) that start at the clamps (i below wlo, i past wlo + W - 1, the
    diagonal above K - 1), on row 0 or column 0, in state 3, or a few
    diagonals above the block's start (they leave it early), over random
    codes and over codes that move by M, I or D only (tiles left by the
    diagonal, by the row, or by both)."""
    K, B, W, d0 = 64, 300, 200, 1000
    trace = rng.integers(0, 64, (K, B, W)).astype(np.int8)
    wlo = rng.integers(0, 900, B).astype(np.int32)
    i = rng.integers(0, 1000, B).astype(np.int32)
    j = (d0 + rng.integers(-3, K + 1, B) - i).astype(np.int32)
    k = rng.integers(0, 4, B).astype(np.int32)
    yield trace, wlo, d0, i, j, k
    K, B, W, d0 = 96, 301, 160, 500
    wlo = rng.integers(0, 400, B).astype(np.int32)
    kind = np.arange(B) % 6
    i = np.where(kind == 0, wlo - rng.integers(1, 40, B),       # ss < 0
        np.where(kind == 1, wlo + W + rng.integers(0, 40, B),   # ss > W - 1
                 wlo + rng.integers(0, W, B))).astype(np.int32)
    i = np.maximum(i, 1)
    d_rel = np.where(kind == 2, K + rng.integers(0, 20, B),     # d above K - 1
            np.where(kind == 3, rng.integers(0, 6, B),          # leaves early
                     rng.integers(0, K, B)))
    j = (d0 + 1 + d_rel - i).astype(np.int32)
    i[kind == 4] = np.where(rng.random(int((kind == 4).sum())) < 0.5, 0,
                            i[kind == 4])                       # row 0
    j[kind == 4] = np.where(i[kind == 4] == 0, j[kind == 4], 0)  # or col 0
    k = np.where(kind == 5, 3, rng.integers(0, 3, B)).astype(np.int32)
    for code in (None, 0, 1, 2):
        if code is None:
            trace = rng.integers(0, 64, (K, B, W)).astype(np.int8)
        else:  # every state's predecessor is `code`
            trace = np.full((K, B, W), code * 21, np.int8)
        yield trace, wlo, d0, i.copy(), j.copy(), k.copy()


@pytest.mark.cuda
def test_lowmem_walk_on_random_traces(card):
    """The tile walk against the plain walk, exactly: ops and the walk's
    end (i, j, k), for each of ``_walk_cases``."""
    for case, (trace, wlo, d0, i, j, k) in enumerate(
            _walk_cases(np.random.default_rng(5))):
        trace, wlo, i, j, k = (torch.from_numpy(x)
                               for x in (trace, wlo, i, j, k))
        got = [x.to(card) for x in (i, j, k)]
        before = wavefront.lowmem_walk_launches
        ops = wavefront.lowmem_walk_block(trace.to(card), wlo.to(card), d0,
                                          *got)
        assert wavefront.lowmem_walk_launches == before + 1
        want_ops = wavefront.lowmem_walk_block_reference(trace, wlo, d0, i, j,
                                                         k)
        assert torch.equal(ops.cpu(), want_ops), case
        for g, w in zip(got, (i, j, k)):
            assert torch.equal(g.cpu(), w), case


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,K", [(3, 900, 300, 8), (2, 1, 40, 16),
                                     (2, 40, 1, 16), (3, 50, 30, 128),
                                     (4, 300, 320, 64)])
def test_lowmem_on_card_equals_cpu(card, B, n, m, K):
    alpha, beta = _lowmem_pairs(B, n, m, seed=n + m)
    kw = dict(checkersize=K)
    on_card = wavefront.affine_gap_lowmem_batch(alpha, beta, HUMAN_CHIMP_TWO,
                                                -600, -150, device=card, **kw)
    on_cpu = wavefront.affine_gap_lowmem_batch(alpha, beta, HUMAN_CHIMP_TWO,
                                               -600, -150, device="cpu", **kw)
    for (gs, gops, gi, gj), (ws, wops, wi, wj) in zip(on_card, on_cpu):
        assert (gs, gi, gj) == (ws, wi, wj)
        assert np.array_equal(gops, wops)
    route = align.affine_gap_lowmem(alpha[0], beta[0], HUMAN_CHIMP_TWO, -600,
                                    -150, checkersize=K, device=card)
    assert route[0] == on_card[0][0]
    assert [(c.run_length, c.op) for c in route[1]] == \
        [(c.run_length, c.op) for c in align.affine_gap_lowmem(
            alpha[0], beta[0], HUMAN_CHIMP_TWO, -600, -150, checkersize=K,
            device="cpu")[1]]


def _score_pairs(shape: tuple, n: int, m: int, seed: int):
    """Pairs of n x m with leading dims `shape`: relatives of their alphas
    (a gap, SNPs, N codes), random pairs, and codes outside 0..4 (alpha
    clips them; beta scores negatives as 1 and codes above 4 as N)."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 4, (*shape, n)).astype(np.int8)
    beta = rng.integers(0, 4, (*shape, m)).astype(np.int8)
    rows = int(np.prod(shape))
    flat_a, flat_b = alpha.reshape(rows, n), beta.reshape(rows, m)
    for r in range(0, rows if n > 3 else 0, 2):
        rel = np.resize(np.concatenate([flat_a[r, :n // 3],
                                        flat_a[r, n // 3 + 3:]]), m)
        rel[rng.random(m) < 0.04] = rng.integers(0, 5)
        flat_b[r] = rel
    flat_a[0, rng.integers(0, n, min(n, 2))] = [-1, 6][:min(n, 2)]
    flat_b[0, rng.integers(0, m, min(m, 3))] = [-2, 5, 4][:min(m, 3)]
    return alpha, beta


# (P, B, n, m): one cell, m even (the JAX odd pad column) with m > n, n a
# multiple of the 32-row strip, n = 0 (row 0 only), a wider batch, and
# the edges of stream_plan: n below the main plan's strip of 32 R rows
# (100 and 129: a smaller R, or one ragged strip), n < 64 (the smallest
# R), m much wider than n, odd m, and a ragged last strip
_STREAM_CASES = [(2, 3, 1, 1, "humanChimp"), (2, 5, 300, 512, "humanChimp"),
                 (4, 7, 64, 64, "plusMinusOne"), (2, 2, 0, 5, "humanChimp"),
                 (6, 64, 257, 300, "asymmetric"),
                 (2, 9, 100, 100, "humanChimp"), (2, 5, 129, 301, "asymmetric"),
                 (2, 4, 40, 40, "plusMinusOne"), (2, 3, 64, 4096, "humanChimp"),
                 (4, 6, 513, 1023, "asymmetric")]


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,n,m,scoring", _STREAM_CASES)
def test_stream_kernel_equals_plain(card, P, B, n, m, scoring):
    """affine_stream (K8) against affine_stream_reference."""
    scores, go, ge = {"humanChimp": (HUMAN_CHIMP_TWO, -600, -150),
                      "plusMinusOne": (PLUS_MINUS_ONE, -1, -1),
                      "asymmetric": (ASYMMETRIC, -400, -30)}[scoring]
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _score_pairs((P, B), n, m, P + n + m))
    sc = torch.as_tensor(scores, dtype=torch.int32, device=card)
    before = wavefront.affine_stream_launches
    got = wavefront.wavefront_affine_stream(alpha, beta, sc, n=n, m=m,
                                            gap_open=go, gap_extend=ge)
    want = wavefront.affine_stream_reference(alpha, beta, sc, go, ge)
    torch.cuda.synchronize()
    assert wavefront.affine_stream_launches == before + 1
    assert got.shape == (P, B) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 1), (77, 77), (300, 513), (1000, 1030)])
def test_stream_kernel_each_rows_per_lane(card, n, m):
    """affine_stream at every count of rows a lane it is built for (one
    strip, several, a ragged last strip), against affine_stream_reference,
    with the launch its library reports: no spill, at most 128 registers,
    so that 4 blocks of 4 warps share an SM."""
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _score_pairs((2, 6), n, m, n + m))
    sc = torch.as_tensor(ASYMMETRIC, dtype=torch.int32, device=card)
    want = wavefront.affine_stream_reference(alpha, beta, sc, -400, -30)
    for R in wavefront._stream_built()["rows_per_lane"]:
        plan = wavefront.stream_launch_plan(12, n, m, R)
        assert plan["spill_bytes"] == 0 and plan["registers"] <= 128, plan
        assert plan["blocks_per_sm"] >= 4, plan
        out = torch.empty((2, 6), dtype=torch.int32, device=card)
        got = wavefront._stream_launch(alpha, beta, sc, -400, -30, plan, out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), R


# (B, n, m, r_rows): r_rows dividing n, n = 1, r_rows not dividing n, one
# block (n < r_rows), r_rows + 1 > 1024 lanes, and 5,801 lanes (two row
# blocks of more rows than one strip of the widest plan)
_BLOCKED_CASES = [(3, 24, 23, 8), (2, 1, 9, 4), (5, 1000, 300, 384),
                  (4, 100, 120, 512), (2, 3000, 200, 1500), (2, 6000, 40, 5800)]


def _blocked_args(card, B, n, m):
    """_score_pairs of n x m with fin_b of their own n_b x m_b (pair 0
    the full widths) on the card."""
    alpha, beta = _score_pairs((B,), n, m, B + n)
    rng = np.random.default_rng(n)
    fin = (rng.integers(1, n + 1, B) + rng.integers(1, m + 1, B)).astype(
        np.int32)
    fin[0] = n + m
    return [torch.from_numpy(x).to(card) for x in (alpha, beta, fin)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,r_rows", _BLOCKED_CASES)
def test_blocked_kernel_equals_plain(card, B, n, m, r_rows):
    """wavefront_align_blocked (K9's contract, one launch of
    affine_score_diag for all row blocks) against affine_block_reference
    on all r_rows + 1 lanes, with pairs of their own n_b x m_b below the
    padded widths."""
    args = _blocked_args(card, B, n, m)
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    before = wavefront.affine_block_launches
    kernel_before = wavefront.affine_score_diag_launches
    got = wavefront.wavefront_align_blocked(*args, sc, n=n, m=m,
                                            gap_open=-600, gap_extend=-150,
                                            r_rows=r_rows)
    want = wavefront.affine_block_reference(*args, sc, -600, -150, r_rows)
    torch.cuda.synchronize()
    nb = -(-n // r_rows)
    assert wavefront.affine_block_launches == before + 1
    assert wavefront.affine_score_diag_launches == kernel_before + 1
    assert got.shape == (nb, B, r_rows + 1) and torch.equal(got, want)


# K2's score mode, (B, n, m, fin): fin_b of each pair's own n_b x m_b
# ("own"; _pairs_batch: one pair of n_b = 0, negative codes), those one
# below ("below"), past n + m, 0, and 1 ("edges"); m < n; n = 0; one pair
# of 20,000 rows (79 strips at R = 8)
_SCORE_MODE_CASES = [(6, 300, 200, "own"), (6, 300, 200, "below"),
                     (5, 90, 70, "edges"), (4, 200, 50, "own"),
                     (3, 0, 7, "edges"), (1, 20_000, 300, "own")]


def _score_mode_args(card, B, n, m, fin_kind):
    alpha, beta, fin = _pairs_batch(B, max(n, 1), m, B + n + m)
    alpha = alpha[:, :n]
    if n == 0:
        fin = np.minimum(fin, m)
    if fin_kind == "below":
        fin = fin - 1 - np.arange(B) % 3
    elif fin_kind == "edges":
        fin[:4] = [n + m + 1, 0, 1, n + m][:min(B, 4)]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(card)
            for x in (alpha, beta, fin.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,fin_kind", _SCORE_MODE_CASES)
def test_score_mode_kernel_equals_plain(card, B, n, m, fin_kind):
    """K2's score mode (affine_wavefront with_trace=False, one launch of
    affine_score_diag) against affine_wavefront_reference on all n + 1
    lanes."""
    args = _score_mode_args(card, B, n, m, fin_kind)
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    before = wavefront.affine_launches
    kernel_before = wavefront.affine_score_diag_launches
    got = wavefront.affine_wavefront(*args, sc, -600, -150, False)
    want = wavefront.affine_wavefront_reference(*args, sc, -600, -150, False)
    torch.cuda.synchronize()
    assert wavefront.affine_launches == before + 1
    assert wavefront.affine_score_diag_launches == kernel_before + 1
    assert got.shape == (B, n + 1) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("blocked", *c) for c in _BLOCKED_CASES]
                         + [("score", *c) for c in _SCORE_MODE_CASES])
def test_score_diag_each_plan(card, case):
    """affine_score_diag at every rows a lane it is built for and at 1, 2,
    3 and 16 warps a pair (one warp a strip in turn, strips pipelined over
    warps, more warps than strips), against the plain versions, with the
    launch its library reports: the plan's block shape, at most 128
    registers a thread, so that an SM holds 4 blocks of one warp a pair
    (16 warps, as affine_stream), and no spill below 8 rows a lane. At 8
    rows a lane ptxas keeps 24-48 bytes on the stack (tools/score_timing.py
    sass); 64 bytes bound it."""
    kind, B, n, m, extra = case
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    if kind == "blocked":
        r_rows = extra
        args = _blocked_args(card, B, n, m)
        want = wavefront.affine_block_reference(*args, sc, -600, -150, r_rows)
        nb = -(-n // r_rows)
        rows, Rb = nb * r_rows, r_rows
    else:
        args = _score_mode_args(card, B, n, m, extra)
        want = wavefront.affine_wavefront_reference(*args, sc, -600, -150,
                                                    False)[None]
        nb, rows, Rb = 1, n, n
    for R in wavefront._score_diag_built()["rows_per_lane"]:
        for W in (1, 2, 3, 16):
            plan = wavefront.score_diag_launch_plan(B, rows, m, R, W)
            assert plan["threads"] == 32 * plan["warps_per_block"], plan
            assert plan["launch_blocks"] == plan["blocks"], plan
            assert plan["registers"] <= 128, plan
            assert plan["spill_bytes"] <= (64 if R == 8 else 0), plan
            assert W > 1 or plan["blocks_per_sm"] >= 4, plan
            out = torch.empty_like(want)
            got = wavefront._score_diag_launch(*args, sc, -600, -150, rows, Rb,
                                               nb, plan, out)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (R, W)


@pytest.mark.cuda
def test_score_kernels_agree(card):
    """K8, K9 and K2's score mode give the same score for every pair of
    one batch."""
    P, B, n, m, R = 4, 16, 200, 230, 64
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _score_pairs((P, B), n, m, 9))
    kw = dict(gap_open=-600, gap_extend=-150)
    stream = wavefront.wavefront_affine_stream(alpha, beta, HUMAN_CHIMP_TWO,
                                               n=n, m=m, **kw)
    a2, b2 = alpha.reshape(P * B, n), beta.reshape(P * B, m)
    fin = torch.full((P * B,), n + m, dtype=torch.int32, device=card)
    k2 = wavefront.wavefront_align(a2, b2, fin, HUMAN_CHIMP_TWO,
                                   with_trace=False, **kw)[:, n]
    blocked = wavefront.wavefront_align_blocked(a2, b2, fin, HUMAN_CHIMP_TWO,
                                                n=n, m=m, r_rows=R, **kw)
    k9 = blocked[(n - 1) // R, :, n - (n - 1) // R * R]
    assert torch.equal(stream.reshape(-1), k2)
    assert torch.equal(k9, k2)
    # numpy inputs go to the card by default
    from_numpy = wavefront.wavefront_affine_stream(
        alpha.cpu().numpy(), beta.cpu().numpy(), HUMAN_CHIMP_TWO, n=n, m=m,
        **kw)
    assert from_numpy.device.type == "cuda" and torch.equal(from_numpy, stream)
    blocked_np = wavefront.wavefront_align_blocked(
        a2.cpu().numpy(), b2.cpu().numpy(), fin.cpu().numpy(),
        HUMAN_CHIMP_TWO, n=n, m=m, r_rows=R, **kw)
    assert blocked_np.device.type == "cuda" and torch.equal(blocked_np,
                                                            blocked)


# --- the variant caller, the motif scan and popgen -----------------------

def _variant_genome(rng, sizes=(("chr1", 12_000), ("chr2", 6_000))):
    """Random chromosomes with an N run, as base codes."""
    genome = {}
    for name, size in sizes:
        g = rng.integers(0, 4, size).astype(np.int8)
        g[size // 3:size // 3 + 40] = dna.N
        genome[name] = g
    return genome


def _plant(genome, rng, n_snv: int, n_indel: int, min_gap: int = 25):
    """{chrom: {pos0: (kind, payload)}}: SNVs (alt code) and 1-5 bp
    deletions (length) and insertions (codes), at least min_gap apart and
    away from the N run."""
    out = {}
    for name, g in genome.items():
        cands = [p for p in range(200, len(g) - 200, min_gap)
                 if not (g[max(0, p - 10):p + 10] == dna.N).any()]
        pick = rng.choice(cands, n_snv + n_indel, replace=False).tolist()
        v = {}
        for i, p in enumerate(pick):
            if i < n_indel and i % 2:
                v[p] = ("del", int(rng.integers(1, 6)))
            elif i < n_indel:
                v[p] = ("ins", rng.integers(0, 4, int(rng.integers(1, 6)))
                        .astype(np.int8))
            else:
                v[p] = ("snv", int((g[p] + rng.integers(1, 4)) % 4))
        out[name] = v
    return out


def _walk_read(g, start: int, qlen: int, variants: dict):
    """The bases and cigar ops of a read of qlen bases whose alignment
    starts at 0-based start, through the variants given."""
    bases, ops = [], []
    pos = start
    while len(bases) < qlen and pos < len(g):
        kind, payload = variants.get(pos, (None, None))
        if kind == "del" and ops:
            ops.append(("D", payload))
            pos += payload
            continue
        if kind == "ins" and ops and qlen - len(bases) > len(payload) + 1:
            bases.extend(payload.tolist())
            ops.append(("I", len(payload)))
        bases.append(payload if kind == "snv" else int(g[pos]))
        ops.append(("M", 1))
        pos += 1
    merged = []
    for op, n in ops:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + n)
        else:
            merged.append((op, n))
    return np.asarray(bases, np.int8), merged


def _sample_sam(genome, variants, n_reads: int, read_len: int, seed: int,
                mutant_frac: float) -> str:
    """Coordinate-sorted SAM text of n_reads reads: a fraction from the
    mutant haplotype; sequencing errors, N and lowercase bases; paired and
    unpaired flags on both strands; low mapq; soft clips and terminal
    insertions; tags; a few unmapped reads at the end."""
    rng = np.random.default_rng(seed)
    names = list(genome)
    sizes = np.array([len(genome[n]) for n in names], np.float64)
    recs = []
    for r in range(n_reads):
        ci = int(rng.choice(len(names), p=sizes / sizes.sum()))
        g = genome[names[ci]]
        clip = int(rng.integers(1, 6)) if rng.random() < 0.1 else 0
        term_ins = int(rng.integers(1, 3)) if rng.random() < 0.03 else 0
        start = int(rng.integers(0, len(g) - read_len - 20))
        mutant = rng.random() < mutant_frac
        seq, ops = _walk_read(g, start, read_len - clip - term_ins,
                              variants[names[ci]] if mutant else {})
        err = rng.random(len(seq)) < 0.005
        seq[err] = (seq[err] + rng.integers(1, 4, int(err.sum()))) % 4
        seq[rng.random(len(seq)) < 0.001] = dna.N
        head = rng.integers(0, 4, clip + term_ins).astype(np.int8)
        seq = np.concatenate([head, seq])
        cig = ([("S", clip)] if clip else []) + (
            [("I", term_ins)] if term_ins else []) + ops
        text = dna.to_string(seq)
        if rng.random() < 0.05:
            k = int(rng.integers(0, len(text)))
            text = text[:k] + text[k:].lower()
        if rng.random() < 0.5:
            flag = 1 + (64 if rng.random() < 0.5 else 128)
            rnext, pnext = "=", start + 200
        else:
            flag, rnext, pnext = 0, "*", 0
        flag |= 16 if rng.random() < 0.5 else 0
        mapq = 60 if rng.random() < 0.9 else int(rng.integers(0, 30))
        qual = "*" if rng.random() < 0.3 else "I" * len(text)
        tags = ("\tNM:i:1\tRG:Z:g1\tXS:f:1.5" if rng.random() < 0.3
                else "")
        cigar = "".join(f"{n}{op}" for op, n in cig)
        recs.append((ci, start + 1, f"r{seed}_{r}\t{flag}\t{names[ci]}\t"
                     f"{start + 1}\t{mapq}\t{cigar}\t{rnext}\t{pnext}\t0\t"
                     f"{text}\t{qual}{tags}"))
    recs.sort(key=lambda x: (x[0], x[1]))
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    lines += [f"@SQ\tSN:{n}\tLN:{len(genome[n])}" for n in names]
    lines += [r[2] for r in recs]
    for u in range(3):
        seq = dna.to_string(rng.integers(0, 4, read_len).astype(np.int8))
        lines.append(f"u{seed}_{u}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*")
    return "".join(ln + "\n" for ln in lines)


def _write_reference(path: str, genome) -> None:
    """FASTA of 60-base lines, lowercase from the 500th base of each
    chromosome for 300 bases, and its .fai."""
    from gonomics_tpu_torch.io import fai

    with open(path, "w") as f:
        for name, g in genome.items():
            s = dna.to_string(g)
            s = s[:500] + s[500:800].lower() + s[800:]
            f.write(f">{name}\n")
            f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
    fai.write_index(fai.create_index(path), path + ".fai")


def _variant_inputs(tmp, seed: int = 0, n_reads: int = 6000,
                    read_len: int = 100):
    """ref.fa (+ .fai), exp.sam (half its reads from the mutant haplotype)
    and norm.sam under the directory tmp; returns (ref, exp, norm,
    variants)."""
    import os

    rng = np.random.default_rng(seed)
    genome = _variant_genome(rng)
    variants = _plant(genome, rng, n_snv=12, n_indel=6)
    ref = os.path.join(tmp, "ref.fa")
    _write_reference(ref, genome)
    paths = []
    for name, frac, s in (("exp", 0.5, seed + 1), ("norm", 0.0, seed + 2)):
        p = os.path.join(tmp, f"{name}.sam")
        with open(p, "w") as f:
            f.write(_sample_sam(genome, variants, n_reads, read_len, s, frac))
        paths.append(p)
    return ref, paths[0], paths[1], variants


def _card_mesh(card, shape):
    from gonomics_tpu_torch.parallel import make_mesh

    d, s = shape
    return make_mesh(devices=[card] * (d * s), data=d, seq=s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 2)])
def test_pileup_counts_on_card_equal_cpu(card, shape, tmp_path):
    """shard_pileup_counts on a mesh of the repeated card equals the same
    mesh of CPU devices (whole int32 tensor), and the pileup counted on
    the card equals the host's native scatter, chromosome for
    chromosome."""
    from gonomics_tpu_torch import parallel, pileup
    from gonomics_tpu_torch.io import sam

    d, s = shape
    rng = np.random.default_rng(d * 10 + s)
    span, n = 100_003, 400_000
    rel = rng.integers(-5, span + 5, n).astype(np.int32)
    code = rng.integers(0, 26, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    got = parallel.shard_pileup_counts(_card_mesh(card, shape), span=span)(
        rel, code, valid)
    cpu = parallel.make_mesh(devices=["cpu"] * (d * s), data=d, seq=s)
    want = parallel.shard_pileup_counts(cpu, span=span)(rel, code, valid)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    _, exp, _, _ = _variant_inputs(str(tmp_path))
    header = sam.read_header_text(exp)
    host = pileup.pileup_dense_from_sam_path(exp, header, 10)
    dev = pileup.pileup_dense_from_sam_path(exp, header, 10,
                                            mesh=_card_mesh(card, shape))
    assert sorted(host) == sorted(dev) == [0, 1]
    for k in host:
        assert dev[k].lo == host[k].lo
        assert dev[k].counts.dtype == np.int32
        assert np.array_equal(dev[k].counts, host[k].counts.astype(np.int32))
        assert dev[k].ins == host[k].ins and dev[k].dels == host[k].dels


@pytest.mark.cuda
def test_call_variants_on_card_equals_cpu(card, tmp_path):
    """callVariants with the pileup counted on the card (meshes (1, 1) and
    (4, 2) of the repeated card, and the CLI's --mesh) writes the VCF of
    the host count, byte for byte, at default and loosened thresholds."""
    from gonomics_tpu_torch.cli import call_variants as cv

    ref, exp, norm, _ = _variant_inputs(str(tmp_path))
    default = None
    for loose in ({}, {"max_p": 1.1, "min_af": 0, "min_coverage": 0}):
        outs = []
        for mesh in (None, _card_mesh(card, (1, 1)),
                     _card_mesh(card, (4, 2))):
            out = str(tmp_path / f"v{len(outs)}.vcf")
            cv.call_variants([exp], [norm], ref, out, mesh=mesh, **loose)
            with open(out, "rb") as f:
                outs.append(f.read())
        assert outs[0] == outs[1] == outs[2]
        assert outs[0].count(b"\n") > 9 + (1000 if loose else 10)
        default = default or outs[0]
    out = str(tmp_path / "cli.vcf")
    cv.main(["-i", exp, "-n", norm, "-r", ref, "-o", out, "--mesh"])
    with open(out, "rb") as f:
        assert f.read() == default


@pytest.mark.cuda
def test_motif_scan_on_card_equals_cpu(card):
    """The scan on the card (device=None) equals the CPU's bit for bit,
    with TF32 allowed for cuDNN and matmuls, which the scan does not use."""
    from gonomics_tpu_torch import motif

    rng = np.random.default_rng(2)
    pm = motif.PositionMatrix(mat=rng.normal(0, 1.5, (4, 20)))
    seq = rng.integers(0, 4, 300_000).astype(np.int8)
    seq[rng.random(seq.size) < 0.01] = rng.integers(4, 11)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = motif.scan_scores_device(pm, seq)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert got.device.type == "cuda"
    want = motif.scan_scores_device(pm, seq, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert bool(torch.isinf(want).any()) and bool(torch.isfinite(want).any())


def _grid_bound(n, want):
    """rtol 1e-5, atol 1e-6, plus 8 float32 ulp of the grid's largest
    terms, lgamma(n + 1) + |F| (tests/test_torch_popgen.py)."""
    import math

    lg = np.array([math.lgamma(float(x) + 1) for x in n])
    return (1e-6 + 1e-5 * np.abs(want)
            + 8 * float(np.finfo(np.float32).eps) * (lg + np.abs(want)))


@pytest.mark.cuda
def test_popgen_grid_on_card_equals_cpu(card):
    """afs_sample_density_grid on the card (device=None) against the CPU:
    NaN in the same places (k = n - 1), the rest within the float32 bound
    of tests/test_torch_popgen.py."""
    from gonomics_tpu_torch import popgen

    rng = np.random.default_rng(6)
    n = rng.integers(2, 200, 8192)
    k = (rng.random(8192) * (n - 1)).astype(np.int64) + 1
    alpha = rng.uniform(-20, 20, 8192)
    got = popgen.afs_sample_density_grid(n, k, alpha)
    assert got.device.type == "cuda"
    got = got.cpu().numpy()
    want = popgen.afs_sample_density_grid(n, k, alpha, device="cpu").numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan) and nan[k == n - 1].all()
    assert (np.abs(got - want) <= _grid_bound(n, want))[~nan].all()


@pytest.mark.cuda
def test_wright_fisher_on_card_reproducible(card):
    from gonomics_tpu_torch import popgen

    a = popgen.wright_fisher_sim(10_000, 1_000, s=0.01, seed=5)
    b = popgen.wright_fisher_sim(10_000, 1_000, s=0.01, seed=5)
    assert a.device.type == "cuda" and a.shape == (1_000,)
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a <= 1)).all()) and float(a[-1]) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("eps,lam", [(0.01, 0.0), (0.01, 0.05), (0.0, 0.0),
                                     (0.5, 0.6)])
def test_genotype_batch_on_card_equals_cpu(card, eps, lam):
    """diploid_base_call_batch on the card (device=None) equals its
    device="cpu" call, over seeded counts with empty rows and N and
    lower-case references, both priors; eps = 0 and eps + lam >= 1 give
    -inf * 0 = NaN posteriors, where both take the first NaN."""
    from gonomics_tpu_torch import genotype

    rng = np.random.default_rng(31)
    counts = rng.integers(0, 30, (20_000, 4))
    counts[::9] = 0
    refs = rng.integers(0, 7, 20_000)
    for prior in (genotype.make_diploid_base_prior_cache(0.01, 3.0),
                  genotype.make_diploid_base_flat_prior_cache()):
        got = genotype.diploid_base_call_batch(counts, refs, prior, eps, lam)
        want = genotype.diploid_base_call_batch(counts, refs, prior, eps,
                                                lam, device="cpu")
        assert got.dtype == np.int8 and np.array_equal(got, want)


# (B, n, m, K, cuts, CL): one forward block cut into strips [cuts[k],
# cuts[k + 1]) of lanes, each strip a launch of affine_fwd_block's strip
# mode taking its left edge from the strip before it, exact against the
# plain version: CL None is the wrapper's plan, else CL forced. Uneven
# strips of 1001 lanes at clusters of 8, 3 and 1; an empty strip in the
# middle and one at the end; strips of 1 and 2 lanes; m = 1; 12,001 lanes
# in two strips, the first at a cluster of 1 (6,001 lanes a block: its
# state in a global scratch), the second at clusters of 2 (3,000 a block,
# shared memory); and 8 pairs of 16,385 lanes in 4 strips at the plan,
# bench.py's width on a (1, 4) mesh.
_STRIP_CASES = [(3, 1000, 300, 96, (0, 300, 301, 640, 1001), 8),
                (3, 1000, 300, 96, (0, 250, 1001), 3),
                (3, 1000, 300, 96, (0, 500, 500, 1001, 1001), 1),
                (2, 40, 1, 16, (0, 1, 3, 41), None),
                (2, 12000, 100, 512, (0, 6001, 12001), 1),
                (2, 12000, 100, 512, (0, 6001, 12001), 2),
                (8, 16384, 16384, 1024, (0, 4097, 8194, 12291, 16385), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,K,cuts,CL", _STRIP_CASES)
def test_seq_parallel_strip_equals_plain(card, B, n, m, K, cuts, CL):
    """affine_fwd_strip on the first, a middle and the last block of a
    forward, strip after strip: the end state, the edge handed to the
    next strip and the per-pair capture (into junk that only diagonal
    fin_b may change) exactly equal to the plain version's; the strips
    stitched equal affine_fwd_block's end state; an empty strip launches
    nothing and hands on the edge it was given."""
    alpha, beta = (torch.from_numpy(x).to(card)
                   for x in _lowmem_pairs(B, n, m, B + n + len(cuts)))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    nb = (n + m - 1) // K + 1
    rng = np.random.default_rng(n + K)
    if 6001 in cuts:
        assert not wavefront.state_in_shared_memory(
            wavefront.fwd_block_lanes(6001, 1), "affine")
    for blk in sorted({0, nb // 2, nb - 1}):
        d0 = blk * K
        state = (wavefront.initial_state(B, n, -600, card) if blk == 0 else
                 wavefront.lowmem_forward(alpha, beta, sc, -600, -150,
                                          K)[0][blk])
        # each pair's fin inside this block, or past it
        fin = torch.from_numpy(rng.integers(d0 + 1, d0 + K + 3, B).astype(
            np.int32)).to(card)
        whole = wavefront.affine_fwd_block_reference(alpha, beta, state, d0,
                                                     n + m, sc, -600, -150, K)
        edge = edge_want = None
        outs = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            junk = torch.from_numpy(rng.integers(-9, 9, (3, B, hi - lo)).astype(
                np.int32)).to(card)
            cap, cap_want = junk.clone(), junk.clone()
            st = state[..., lo:hi].contiguous()
            before = wavefront.affine_fwd_strip_launches
            if CL is None:
                got = wavefront.affine_fwd_strip(alpha, beta, st, edge, d0,
                                                 fin, cap, lo, sc, -600, -150,
                                                 K)
            else:
                got = wavefront._fwd_strip_launch(alpha, beta, st, edge, d0,
                                                  fin, cap, lo, sc, -600,
                                                  -150, K, CL)
            want = wavefront.affine_fwd_strip_reference(
                alpha, beta, st, edge_want, d0, fin, cap_want, lo, sc, -600,
                -150, K)
            torch.cuda.synchronize()
            assert wavefront.affine_fwd_strip_launches == before + (hi > lo)
            assert torch.equal(got[0], want[0]), (blk, lo)
            assert torch.equal(got[1], want[1]), (blk, lo)
            assert torch.equal(cap, cap_want), (blk, lo)
            if hi == lo and edge is not None:
                assert torch.equal(got[1], edge)
            outs.append(got[0])
            edge, edge_want = got[1], want[1]
        assert torch.equal(torch.cat(outs, dim=3), whole[0]), blk


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [2, 4])
def test_seq_parallel_on_card_equals_cpu(card, seq):
    """shard_seq_affine_align and shard_seq_affine_score on a (1, seq)
    mesh of the repeated card (a stream a strip) equal the same mesh of
    CPU devices and, for the cigars, affine_gap_lowmem_batch on the card;
    the checkpoints equal lowmem_forward's."""
    from gonomics_tpu_torch import parallel

    B, n, m, K = 3, 2000, 1900, 256
    alpha, beta = _lowmem_pairs(B, n, m, seq)
    meshes = (_card_mesh(card, (1, seq)),
              parallel.make_mesh(devices=["cpu"] * seq, data=1, seq=seq))
    before = wavefront.affine_fwd_strip_launches
    got, cpu = (parallel.shard_seq_affine_align(
        mesh, HUMAN_CHIMP_TWO, n=n, m=m, gap_open=-600, gap_extend=-150,
        checkersize=K)(alpha, beta) for mesh in meshes)
    nb = (n + m - 1) // K + 1
    assert wavefront.affine_fwd_strip_launches == before + nb * seq
    lowmem = wavefront.affine_gap_lowmem_batch(alpha, beta, HUMAN_CHIMP_TWO,
                                               -600, -150, checkersize=K,
                                               device=card)
    for g, c, w in zip(got, cpu, lowmem):
        assert (g[0], g[2], g[3]) == (c[0], c[2], c[3]) == (w[0], w[2], w[3])
        assert np.array_equal(g[1], c[1]) and np.array_equal(g[1], w[1])
    ta, tb = (torch.from_numpy(x).to(card) for x in (alpha, beta))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=card)
    # the unsharded forward still queued on the caller's stream when the
    # strips start: they must wait for the state it leaves them
    want_ck, want_cap = wavefront.lowmem_forward(ta, tb, sc, -600, -150, K)
    ck, cap = parallel.shard_seq_forward(meshes[0], ta, tb, sc, -600, -150, K)
    assert torch.equal(ck, want_ck) and torch.equal(cap, want_cap)
    # the score variant on random-length pairs, at blocks of 512
    rng = np.random.default_rng(seq)
    nv = rng.integers(1, n + 1, B).astype(np.int32)
    fin = (nv + rng.integers(1, m + 1, B)).astype(np.int32)
    parallel.SEQ_SCORE_K, K_default = 512, parallel.SEQ_SCORE_K
    try:
        scores = [parallel.shard_seq_affine_score(
            mesh, HUMAN_CHIMP_TWO, n=n, m=m, gap_open=-600,
            gap_extend=-150)(alpha, beta, fin, nv) for mesh in meshes]
    finally:
        parallel.SEQ_SCORE_K = K_default
    assert scores[0].device.type == "cuda"
    assert torch.equal(scores[0].cpu(), scores[1])
    res = wavefront.affine_wavefront(ta, tb, torch.from_numpy(fin).to(card),
                                     sc, -600, -150, False)
    assert torch.equal(scores[0], res[torch.arange(B), torch.from_numpy(
        nv).long().to(card)])


@pytest.mark.cuda
def test_pipeline_step_on_card_equals_cpu(card):
    """pipeline_step on a 2 x 2 mesh of the repeated card equals the same
    mesh of CPU devices: scores and counts, whole int32 tensors."""
    from gonomics_tpu_torch import parallel

    out = []
    for mesh in (_card_mesh(card, (2, 2)),
                 parallel.make_mesh(devices=["cpu"] * 4, data=2, seq=2)):
        step = parallel.pipeline_step(mesh, n=300, m=280, genome_len=10_000,
                                      scores=HUMAN_CHIMP_TWO, gap_open=-600,
                                      gap_extend=-150)
        args = parallel.example_step_inputs(mesh, B=12, n=300, m=280,
                                            genome_len=10_000, seed=3)
        out.append(step(*args))
    (gs, gc), (cs, cc) = out
    assert gs.device.type == "cuda" and gs.shape == (12, 301)
    assert torch.equal(gs.cpu(), cs) and torch.equal(gc.cpu(), cc)
    assert int(cc.sum()) == 12 * 300


@pytest.mark.cuda
def test_seq_parallel_across_cards(card):
    """On a machine with several cards, the sharded paths over distinct
    cards (each strip's edge copied to the next card, the checkpoints and
    counts gathered on the first): shard_seq_affine_align and
    shard_seq_affine_score on a (1, cards) mesh, pipeline_step on
    make_mesh()'s grid, each equal to the same mesh of CPU devices."""
    from gonomics_tpu_torch import parallel

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    B, n, m, K = 3, 2000, 1900, 256
    alpha, beta = _lowmem_pairs(B, n, m, count)
    cards = parallel.make_mesh(data=1, seq=count)
    assert len({d for d in cards.devices[0]}) == count
    cpu = parallel.make_mesh(devices=["cpu"] * count, data=1, seq=count)
    got, want = (parallel.shard_seq_affine_align(
        mesh, HUMAN_CHIMP_TWO, n=n, m=m, gap_open=-600, gap_extend=-150,
        checkersize=K)(alpha, beta) for mesh in (cards, cpu))
    for g, w in zip(got, want):
        assert (g[0], g[2], g[3]) == (w[0], w[2], w[3])
        assert np.array_equal(g[1], w[1])
    nv = np.full(B, n, np.int32)
    fin = np.full(B, n + m, np.int32)
    scores = [parallel.shard_seq_affine_score(
        mesh, HUMAN_CHIMP_TWO, n=n, m=m, gap_open=-600,
        gap_extend=-150)(alpha, beta, fin, nv).cpu() for mesh in (cards, cpu)]
    assert torch.equal(*scores)
    assert scores[0].tolist() == [g[0] for g in got]
    grid = parallel.make_mesh()
    shape = grid.shape["data"], grid.shape["seq"]
    out = []
    for mesh in (grid, parallel.make_mesh(devices=["cpu"] * count,
                                          data=shape[0], seq=shape[1])):
        step = parallel.pipeline_step(mesh, n=300, m=280, genome_len=10_000,
                                      scores=HUMAN_CHIMP_TWO, gap_open=-600,
                                      gap_extend=-150)
        out.append([x.cpu() for x in step(*parallel.example_step_inputs(
            mesh, B=4 * shape[0], n=300, m=280, genome_len=10_000))])
    assert all(torch.equal(g, w) for g, w in zip(*out))


def _plant_edits(g, rng, snp_every: int, indel_every: int,
                 min_gap: int = 50):
    """The query of one target chromosome g: an insertion or a deletion of
    1-10 bp every ~indel_every bases (alternately), a SNP every
    ~snp_every bases at least min_gap from any indel and off N. Returns
    (query, snps [(1-based pos, ref, alt)], chain blocks [(size, dt,
    dq)])."""
    n = len(g)
    step = indel_every
    at = np.arange(step, n - step // 2, step)
    at = at + rng.integers(-step // 4, step // 4 + 1, len(at))
    indels = []
    for k, p in enumerate(at.tolist()):
        size = int(rng.integers(1, 11))
        indels.append((p, "del" if k % 2 else "ins", size))
    cand = np.arange(snp_every // 2, n - snp_every // 2, snp_every)
    cand = cand + rng.integers(-snp_every // 4, snp_every // 4 + 1,
                               len(cand))
    near = np.zeros(n + 1, bool)
    for p, _, size in indels:
        near[max(0, p - min_gap):p + size + min_gap] = True
    up = dna.to_upper(g)
    snps = {}
    for p in cand.tolist():
        if not near[p] and up[p] < dna.N and (up[p - 2:p + 3] < dna.N).all():
            snps[p] = int((up[p] + rng.integers(1, 4)) % 4)
    parts, blocks, t0 = [], [], 0
    for p, kind, size in indels + [(n, "end", 0)]:
        seg = g[t0:p].copy()
        for s, alt in snps.items():
            if t0 <= s < p:
                seg[s - t0] = alt
        parts.append(seg)
        if kind == "ins":
            parts.append(rng.integers(0, 4, size).astype(np.int8))
            blocks.append((p - t0, 0, size))
            t0 = p
        elif kind == "del":
            blocks.append((p - t0, size, 0))
            t0 = p + size
        else:
            blocks.append((p - t0, 0, 0))
    truth = [(s + 1, dna.to_string(up[s:s + 1]),
              dna.to_string(np.array([a], np.int8)))
             for s, a in sorted(snps.items())]
    return np.concatenate(parts), truth, blocks


def _write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            s = dna.to_string(seq)
            f.write(f">{name}\n")
            f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))


def _tools_inputs(tmp: str, seed: int = 0,
                  sizes=(("chr1", 6000), ("chr2", 3000)),
                  snp_every: int = 150, indel_every: int = 900,
                  minus_strand: tuple = ("chr2",)):
    """t.fa, q.fa and t_q.chain under the directory tmp: random target
    chromosomes (the first with an N run and a lower-case stretch), their
    queries from ``_plant_edits`` (the chromosomes named in minus_strand
    stored reverse-complemented, their chains on the query's - strand),
    one chain a chromosome of the ungapped blocks between the indels.
    Returns (target, query, chain, snps {chrom: [(pos, ref, alt)]}, query
    sequences {chrom: codes as aligned})."""
    import os

    rng = np.random.default_rng(seed)
    target, query, snps, qseqs, chains = [], [], {}, {}, []
    for k, (name, size) in enumerate(sizes):
        g = rng.integers(0, 4, size).astype(np.int8)
        if k == 0:
            g[size // 3:size // 3 + 30] = dna.N
            g[size // 2:size // 2 + 200] += dna.LOWER_A
        q, snps[name], blocks = _plant_edits(g, rng, snp_every, indel_every)
        if k == 0:  # a query base against the N run: a record ggtools drops
            q[size // 3 + 5] = dna.A
        qseqs[name] = q
        minus = name in minus_strand
        target.append((name, g))
        query.append((name, dna.reverse_complement(q) if minus else q))
        head = (f"chain {1000 * (k + 1)} {name} {size} + 0 {size} {name} "
                f"{len(q)} {'-' if minus else '+'} 0 {len(q)} {k + 1}")
        body = [f"{s}\t{dt}\t{dq}" for s, dt, dq in blocks[:-1]]
        chains.append("\n".join([head, *body, str(blocks[-1][0])]) + "\n\n")
    paths = [os.path.join(tmp, n) for n in ("t.fa", "q.fa", "t_q.chain")]
    _write_fasta(paths[0], target)
    _write_fasta(paths[1], query)
    with open(paths[2], "w") as f:
        f.write("#a chain file\n" + "".join(chains))
    return (*paths, snps, qseqs)


def _tool_reads(qseqs, n: int, length: int, seed: int) -> list:
    """n reads of length bases drawn from the query chromosomes, every
    other one reverse-complemented, as (name, codes)."""
    rng = np.random.default_rng(seed)
    names = list(qseqs)
    sizes = np.array([len(qseqs[c]) for c in names], np.float64)
    reads = []
    for i in range(n):
        c = names[int(rng.choice(len(names), p=sizes / sizes.sum()))]
        s = int(rng.integers(0, len(qseqs[c]) - length))
        seq = dna.to_upper(qseqs[c][s:s + length]).astype(np.int8)
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append((f"q{i}_{c}_{s}", seq))
    return reads


def _giraf_mapped(line: str) -> bool:
    """A path and a score of at least 1200 (the SAM projection's
    threshold)."""
    f = line.split("\t")
    return f[5].split(":")[1] != "" and int(f[7]) >= 1200


def _write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{dna.to_string(seq)}\n+\n{'I' * len(seq)}\n")


@pytest.mark.cuda
def test_tools_ggtools_graph_on_card_equals_cpu(card, tmp_path):
    """gonomics-torch gsw ggtools (chain to vcf, vcf to gg), then gsw align
    of the graph on the card (the default engine: K4, K5 and the graph
    walk) against --device cpu: giraf byte-equal, every read mapped."""
    import os

    from gonomics_tpu_torch.cli import main as umbrella

    tmp = str(tmp_path)
    t, q, chain, snps, qseqs = _tools_inputs(tmp, seed=5)
    vcf, gg = os.path.join(tmp, "c.vcf"), os.path.join(tmp, "c.gg")
    umbrella.main(["gsw", "ggtools", chain, "-t", t, "-q", q, "-f", "vcf",
                   "-o", vcf])
    umbrella.main(["gsw", "ggtools", vcf, "-t", t, "-o", gg])
    from gonomics_tpu_torch.io import vcf as vcfio
    got = {(v.chrom, v.pos, v.ref, v.alt[0]) for v in vcfio.read(vcf)[0]}
    assert all((c, *s) in got for c in snps for s in snps[c])
    fq = os.path.join(tmp, "r.fq")
    _write_fastq(fq, _tool_reads(qseqs, 120, 150, seed=6))
    out = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"r.{device}.giraf")
        umbrella.main(["gsw", "align", gg, fq, "-o", path,
                       "--device", device])
        with open(path, "rb") as f:
            out[device] = f.read()
    assert out["cuda"] == out["cpu"]
    lines = out["cuda"].decode().splitlines()
    assert len(lines) == 120
    assert all(_giraf_mapped(ln) for ln in lines)
