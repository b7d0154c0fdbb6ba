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
