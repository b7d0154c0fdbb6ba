"""The port's graph-aligner DPs (gonomics_tpu_torch/ops/wavefront.py
`local_wavefront`, `gsw_right_wavefront`; ops/gsw_dp.py `gsw_walk_pack`
and `GswDpBatch`) against the JAX package, whose Pallas kernels K4
(`_local_kernel`) and K5 (`_gsw_right_kernel`) run here in interpret
mode.

Every value is an integer, so every comparison is exact. The port runs
on CPU tensors, which takes each kernel's plain PyTorch version; the CUDA
kernels are held against those same plain versions on the card by
tests/test_torch_card.py and chip_smoke.py.

K4's trace is defined on every lane (3 outside the job's grid) and is
compared on lanes 0..n whole. K5's trace is compared on the interior, row
0 and column 0: elsewhere the Pallas kernel writes the argmax of its lane
shift's junk, which no walk reads, and the port writes 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gonomics_tpu.align.matrices import HUMAN_CHIMP_TWO
from gonomics_tpu.ops import gsw_dp as jax_dp
from gonomics_tpu.ops import wavefront as jax_wf
from gonomics_tpu_torch.ops import gsw_dp as port_dp
from gonomics_tpu_torch.ops import wavefront as port_wf

PLUS_MINUS_ONE = np.where(np.eye(5, dtype=bool), 1, -1).astype(np.int64)
ASYMMETRIC = HUMAN_CHIMP_TWO.astype(np.int64).copy()
ASYMMETRIC[0, 1], ASYMMETRIC[1, 0] = 60, -400
ASYMMETRIC[2, 3], ASYMMETRIC[3, 2] = -500, 40
SCORINGS = {"humanChimp": (HUMAN_CHIMP_TWO, -600),
            "plusMinusOne": (PLUS_MINUS_ONE, -1),
            "asymmetric": (ASYMMETRIC, -300)}


def _related(rng, win: np.ndarray, length: int, at_end: bool) -> np.ndarray:
    """A read part of `length` bases copied from the end (left jobs) or
    the start (right jobs) of `win`, with SNPs and a 2 bp deletion."""
    src = win[::-1] if at_end else win
    part = np.concatenate([src[:length // 2], src[length // 2 + 2:]])
    part = np.resize(part if len(part) else np.zeros(1, np.int8), length)
    part = part.copy()
    part[rng.random(length) < 0.06] = rng.integers(0, 4)
    return part[::-1] if at_end else part


def _jobs(C: int, n: int, m: int, seed: int, at_end: bool):
    """C jobs padded to (n, m) with code 4, as the graph aligner builds
    them: related genome windows and read parts of mixed lengths, plus an
    empty window, an empty read part, both empty, N codes and lowercase
    or gap codes (5-12)."""
    rng = np.random.default_rng(seed)
    al = np.full((C, n), 4, np.int8)
    be = np.full((C, m), 4, np.int8)
    nv = rng.integers(1, n + 1, C)
    mv = rng.integers(1, m + 1, C)
    nv[-1], mv[-1] = n, m
    for b in range(C):
        win = rng.integers(0, 4, nv[b]).astype(np.int8)
        al[b, :nv[b]] = win
        be[b, :mv[b]] = (_related(rng, win, mv[b], at_end) if b % 4
                         else rng.integers(0, 4, mv[b]))
    nv[0] = 0
    al[0] = 4
    mv[1] = 0
    be[1] = 4
    nv[2] = mv[2] = 0
    al[2] = be[2] = 4
    al[3, ::7] = 4
    be[3, ::5] = 4
    al[4, :6] = [5, 6, 7, 8, 12, 9]
    be[4, :6] = [8, 7, 10, 5, 11, 6]
    return al, be, nv.astype(np.int32), mv.astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(al, be, nv, mv):
    return (jnp.asarray(al), jnp.asarray(be), jnp.asarray(nv[:, None]),
            jnp.asarray(mv[:, None]))


@pytest.mark.parametrize("with_corner", [False, True],
                         ids=["plain", "corner"])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_local_wavefront_matches_jax(scoring, with_corner):
    scores, gap = SCORINGS[scoring]
    C, n, m = 12, 40, 33
    al, be, nv, mv = _jobs(C, n, m, seed=len(scoring), at_end=True)
    want = jax_wf.wavefront_local(*_jax(al, be, nv, mv), scores, n=n, m=m,
                                  gap=gap, with_trace=True,
                                  with_corner=with_corner, interpret=True)
    got = port_wf.local_wavefront(*_torch(al, be, nv, mv), scores, gap,
                                  with_corner=with_corner)
    assert len(got) == len(want) == (4 if with_corner else 3)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        w = w[..., :n + 1]
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))
    bv = got[0].numpy()
    assert (bv[:3] == 0).all() and bv.max() > 0


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_gsw_right_wavefront_matches_jax(scoring):
    scores, gap = SCORINGS[scoring]
    C, n, m = 12, 37, 45
    al, be, nv, mv = _jobs(C, n, m, seed=10 + len(scoring), at_end=False)
    want = jax_wf.wavefront_gsw_right(*_jax(al, be, nv, mv), scores, n=n,
                                      m=m, gap=gap, interpret=True)
    got = port_wf.gsw_right_wavefront(*_torch(al, be, nv, mv), scores, gap)
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k])[:, :n + 1])
    trace, jt = got[2].numpy(), np.asarray(want[2])[:, :, :n + 1]
    assert trace.shape == jt.shape == (n + m, C, n + 1)
    d = np.arange(1, n + m + 1)[:, None, None]
    s = np.arange(n + 1)[None, None, :]
    interior = (s >= 1) & (s <= n) & (d - s >= 1) & (d - s <= m)
    row0 = (s == 0) & (d <= m)
    col0 = (s == d) & (d <= n)
    for name, mask in (("interior", interior), ("row 0", row0),
                       ("column 0", col0)):
        mask = np.broadcast_to(mask, trace.shape)
        np.testing.assert_array_equal(trace[mask], jt[mask], err_msg=name)
    outside = np.broadcast_to(~(interior | row0 | col0), trace.shape)
    assert (trace[outside] == 0).all()


def test_state_in_shared_memory_graph_limits():
    """The graph kernels keep their state in shared memory up to the old
    limits (6 rows of n + 1 int32 lanes for K4, 5 for K5, within 200 KB)
    and in a global scratch above them; the wrappers' checks take any
    window."""
    assert port_wf.state_in_shared_memory(8532, "local")
    assert not port_wf.state_in_shared_memory(8533, "local")
    assert port_wf.state_in_shared_memory(10239, "gsw_right")
    assert not port_wf.state_in_shared_memory(10240, "gsw_right")
    al, be, nv, mv = _torch(np.zeros((1, 10300), np.int8),
                            np.zeros((1, 32), np.int8),
                            np.array([10300], np.int32),
                            np.array([32], np.int32))
    checked = port_wf._graph_inputs(al, be, nv, mv, HUMAN_CHIMP_TWO)
    assert checked[0].shape == (1, 10300)


# What the graph DPs' library reports it is built for (``_graph_built``
# on the card, given here).
_GRAPH_BUILT = {"slots": (1, 2, 3, 4, 5, 6, 8, 12, 16)}


# (C, n, m, mode, (design, slots a lane, state)): the main
# shape, the wide window, row-count edges, the warp design's reach (m + 1
# = 32 x 16) and one past it, where the block design keeps its state in
# shared memory or a global scratch as state_in_shared_memory says
@pytest.mark.parametrize("C,n,m,mode,want", [
    (2048, 192, 128, "local", ("warp", 5, "registers")),
    (2048, 192, 128, "gsw_right", ("warp", 5, "registers")),
    (2, 10300, 32, "local", ("warp", 2, "registers")),
    (1, 40, 31, "gsw_right", ("warp", 1, "registers")),
    (1, 40, 191, "local", ("warp", 6, "registers")),
    (1, 40, 192, "local", ("warp", 8, "registers")),
    (6, 300, 511, "gsw_right", ("warp", 16, "registers")),
    (6, 300, 512, "local", ("block", 0, "shared")),
    (5, 9000, 600, "local", ("block", 0, "global")),
    (5, 9000, 600, "gsw_right", ("block", 0, "shared")),
    (5, 10300, 600, "gsw_right", ("block", 0, "global")),
])
def test_graph_dp_plan(C, n, m, mode, want):
    """graph_dp_design's boundaries (graph_dp_plan's choice, from what the
    library is built for): one warp a job with its m + 1 slots in the
    fewest slots a lane built, the block design past the warp's reach."""
    plan = port_wf.graph_dp_design(n, m, mode, _GRAPH_BUILT)
    assert (plan["design"], plan["slots_per_lane"], plan["state"]) == want
    if plan["design"] == "warp":
        L = plan["slots_per_lane"]
        assert L in _GRAPH_BUILT["slots"] and 32 * L >= m + 1
        assert L == 1 or 32 * _GRAPH_BUILT["slots"][
            _GRAPH_BUILT["slots"].index(L) - 1] < m + 1
    else:
        assert 32 * _GRAPH_BUILT["slots"][-1] < m + 1
        assert plan["state"] == ("shared" if port_wf.state_in_shared_memory(
            n, mode) else "global")
    with pytest.raises(ValueError):
        port_wf.graph_dp_design(n, m, "affine", _GRAPH_BUILT)


@pytest.mark.parametrize("kind,n", [("local", 8600), ("gsw_right", 10300)])
def test_wide_window_matches_jax(kind, n):
    """K4 and K5 at a genome window above their old shared-memory limit
    (8,532 and 10,239 bases): the plain versions equal the JAX kernels, as
    the card's kernels equal the plain versions there (one warp a job, and
    the block design's global scratch for longer read parts;
    tests/test_torch_card.py)."""
    assert not port_wf.state_in_shared_memory(n, kind)
    C, m = 2, 8
    rng = np.random.default_rng(n)
    al = rng.integers(0, 4, (C, n)).astype(np.int8)
    # read parts from the window's end (left jobs) or start (right jobs)
    be = np.ascontiguousarray(al[:, -m:] if kind == "local" else al[:, :m])
    be[1, 3] = (be[1, 3] + 1) % 4
    nv = np.array([n, n - 700], np.int32)
    mv = np.array([m, m - 2], np.int32)
    scores, gap = SCORINGS["humanChimp"]
    if kind == "local":
        want = jax_wf.wavefront_local(*_jax(al, be, nv, mv), scores, n=n,
                                      m=m, gap=gap, with_trace=True,
                                      with_corner=True, interpret=True)
        got = port_wf.local_wavefront(*_torch(al, be, nv, mv), scores, gap,
                                      with_corner=True)
    else:
        want = jax_wf.wavefront_gsw_right(*_jax(al, be, nv, mv), scores, n=n,
                                          m=m, gap=gap, interpret=True)[:2]
        got = port_wf.gsw_right_wavefront(*_torch(al, be, nv, mv), scores,
                                          gap)[:2]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[..., :n + 1],
                                      err_msg=str(k))
    assert int(got[0].max()) > 0


@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("side", ["left", "right"])
def test_walk_pack_matches_jax(side, scoring):
    """The DP and the walk-pack of one side against the jitted
    `_left_full` / `_right_full`: packed rows byte-equal."""
    scores, gap = SCORINGS[scoring]
    C, n, m = 16, 64, 64
    al, be, nv, mv = _jobs(C, n, m, seed=20 + len(scoring),
                           at_end=side == "left")
    full = jax_dp._left_full if side == "left" else jax_dp._right_full
    want = np.asarray(full(*_jax(al, be, nv, mv), scores, n=n, m=m, gap=gap,
                           interpret=True))
    a, b, v, w = _torch(al, be, nv, mv)
    if side == "left":
        _, _, trace, corner = port_wf.local_wavefront(a, b, v, w, scores, gap,
                                                      with_corner=True)
        got = port_dp.gsw_walk_pack("left", trace, corner, n_vec=v, m_vec=w)
    else:
        bv, bd, trace = port_wf.gsw_right_wavefront(a, b, v, w, scores, gap)
        got = port_dp.gsw_walk_pack("right", trace, bv, bd)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    meta = np.ascontiguousarray(want[:, :12]).view(np.int32)
    assert (meta[:, 0] > 0).sum() >= 4  # real alignments were walked


def _wave_jobs(dp, rng_seed: int, Nl: int, Nr: int, max_n: int):
    """A wave's job tensors at the batch's sticky dims."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for side, N, at_end in (("left", Nl, True), ("right", Nr, False)):
        nl = int(rng.integers(1, max_n))
        ml = int(rng.integers(1, max_n))
        n, m = dp.dims_for(side, nl, ml)
        al, be, nv, mv = _jobs(max(N, 5), n, m, rng_seed, at_end)
        nv = np.minimum(nv, nl)
        mv = np.minimum(mv, ml)
        for b in range(len(al)):
            al[b, nv[b]:] = 4
            be[b, mv[b]:] = 4
        out += [al[:N], be[:N], nv[:N], mv[:N]]
    return out


def test_dp_batch_waves_match_jax():
    """`GswDpBatch.finish_wave(start_wave(...))` of the port against the
    JAX class in interpret mode, over waves whose sides have different
    job counts and whose sticky dims grow: (lmeta, lops, rmeta, rops)
    equal, shapes included."""
    scores = np.asarray(HUMAN_CHIMP_TWO, np.int64)
    jdp = jax_dp.GswDpBatch(scores, -600, interpret=True)
    pdp = port_dp.GswDpBatch(scores, -600, device="cpu")
    for seed, Nl, Nr, max_n in ((1, 7, 9, 60), (2, 11, 6, 100)):
        jobs = _wave_jobs(pdp, seed, Nl, Nr, max_n)
        jdp.dims_for("left", *pdp._dims["left"])
        jdp.dims_for("right", *pdp._dims["right"])
        want = jdp.finish_wave(jdp.start_wave(*jobs))
        got = pdp.finish_wave(pdp.start_wave(*jobs))
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=str(k))
        assert got[1].shape[1] == sum(pdp._dims["left"])


def test_empty_wave():
    pdp = port_dp.GswDpBatch(HUMAN_CHIMP_TWO, -600, device="cpu")
    z = np.zeros((0, 64), np.int8)
    zv = np.zeros(0, np.int32)
    wave = pdp.start_wave(z, z, zv, zv, z, z, zv, zv)
    assert wave is None
    lmeta, lops, rmeta, rops = pdp.finish_wave(wave)
    assert lmeta.shape == rmeta.shape == (0, 3)
    assert lops.shape == rops.shape == (0, 0)


def test_one_sided_wave():
    """A wave with right jobs only: the left side decodes to (0, 3) and
    (0, D) (the JAX `unpack_ops` would raise on zero rows)."""
    pdp = port_dp.GswDpBatch(HUMAN_CHIMP_TWO, -600, device="cpu")
    _, _, _, _, al, be, nv, mv = _wave_jobs(pdp, 3, 0, 4, 50)
    z = np.zeros((0, 64), np.int8)
    zv = np.zeros(0, np.int32)
    lmeta, lops, rmeta, rops = pdp.finish_wave(
        pdp.start_wave(z, z, zv, zv, al, be, nv, mv))
    assert lmeta.shape == (0, 3) and lops.shape == (0, 128)
    assert rmeta.shape == (4, 3) and rops.shape == (4, 128)


def test_routes_and_unpack_match_jax():
    rng = np.random.default_rng(4)
    ops = rng.choice(5, size=(40, 23), p=[0.5, 0.15, 0.15, 0.1, 0.1])
    ops[0] = 3
    ops[1] = 0
    ops = ops.astype(np.int8)
    want = jax_dp._routes_walk_order(ops)
    got = port_dp._routes_walk_order(ops)
    assert [[(c.run_length, c.op) for c in r] for r in got] == \
        [[(c.run_length, c.op) for c in r] for r in want]
    packed = rng.integers(0, 256, (9, 6)).astype(np.uint8)
    np.testing.assert_array_equal(port_dp.unpack_ops(packed, 22),
                                  jax_wf.unpack_ops(packed, 22))


def test_argument_checks():
    trace = torch.zeros((4, 2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="side"):
        port_dp.gsw_walk_pack("up", trace,
                              torch.zeros((2, 3), dtype=torch.int32))
