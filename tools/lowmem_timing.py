#!/usr/bin/env python3
"""Where the lowmem path's kernels spend their time, on one CUDA card:
affine_fwd_block (K6, one thread-block cluster a pair), affine_bwd_window
(K7, warps pipelined over strips of a window, one cluster a pair) and the
walk lowmem_walk_block (a tile at a time).

    python3 tools/lowmem_timing.py k6
    python3 tools/lowmem_timing.py k7
    python3 tools/lowmem_timing.py compare [--root DIR]

Every mode works on block 16 of bench.py's lowmem batch (16 pairs of
16,384 x 16,384, K = 1024, W = 2,688, the block chip_smoke.py times), from
the checkpoint and the walk's rows the main path gives it, and times with
CUDA events. Each case prints one JSON line with its time and whether its
result equals the plain version's.

k6: K6 at the wrapper's plan and at forced cluster sizes, for one pair and
    for 16, median of 7 samples; a last line fits microseconds a diagonal
    against the lanes a block sweeps over the one-pair cases whose state is
    in shared memory (the slope is a lane's cost, the intercept what a
    diagonal costs whatever its lanes).
k7: K7 at the wrapper's plan and at forced cluster sizes and lanes a
    thread, for 16 pairs and for one, median of 7 samples, with the launch
    (warps a block, passes, resident clusters) as the kernel's library
    reports it; last, one strip alone (a pair of 63 x 16,384: one warp with
    no edge to wait for), the latency of a warp-step.
compare: K7 and the walk through their public wrappers, the median of 15
    samples of 1 launch and of 15 samples of 5 back-to-back launches each.
    With --root DIR the package is imported from the checkout at DIR (say
    a `git archive` of another commit in a git-ignored directory), so that
    two commits are timed the same way on one card: run parent, change,
    change, parent in one sitting on one card.

Needs a CUDA card; the package builds its kernels into the git-ignored
gonomics_tpu_torch/_build/ of the checkout it is imported from.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import _timing  # noqa: E402
import chip_smoke  # noqa: E402

GO, GE, K, BLOCK = -600, -150, chip_smoke.LOWMEM_K, 16
# (pairs, cluster size or None for the wrapper's plan)
K6_CASES = [(16, None), (16, 8), (16, 7), (16, 6), (16, 5), (16, 4),
            (1, 8), (1, 7), (1, 6), (1, 5), (1, 4), (1, 3), (1, 2)]
# (pairs, cluster size, lanes a thread); None: the plan's
K7_CASES = ([(16, None, None)]
            + [(16, CL, L) for L in (2, 4) for CL in (8, 7, 6, 5, 4, 2)]
            + [(1, None, None), (1, 1, 8), (16, 1, 8)])


def block_state(wavefront, dev):
    """bench.py's lowmem batch on the card, its forward's checkpoints, and
    the walk's (i, j, k) at the entry of block BLOCK."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    alpha, beta = (torch.from_numpy(x).to(dev)
                   for x in chip_smoke.lowmem_pairs())
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    B, n = alpha.shape
    m = beta.shape[1]
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, GO, GE, K)
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((B,), n, dtype=torch.int32, device=dev)
    j = torch.full((B,), m, dtype=torch.int32, device=dev)
    later = list(reversed(range(BLOCK + 1, ck.shape[0])))
    wavefront.lowmem_backward(i, j, k, [b * K for b in later],
                              [ck[b] for b in later], alpha, beta, sc, GO,
                              GE, K)
    return alpha, beta, sc, ck, (i, j, k)


def k6(wavefront, dev, smi: str) -> int:
    alpha, beta, sc, ck, _ = block_state(wavefront, dev)
    n, m = alpha.shape[1], beta.shape[1]
    d0 = BLOCK * K
    state = ck[BLOCK].contiguous()
    want = wavefront.affine_fwd_block_reference(alpha, beta, state, d0,
                                                n + m, sc, GO, GE, K)
    fit, failed = [], 0
    for B, CL in K6_CASES:
        if CL is None:
            CL = wavefront.fwd_block_plan(B, n, dev)["cluster"]
        al, be = alpha[:B].contiguous(), beta[:B].contiguous()
        st = state[:, :, :B].contiguous()

        def run():
            return wavefront._fwd_block_launch(al, be, st, d0, n + m, sc, GO,
                                               GE, K, CL)

        out, cap = run()
        torch.cuda.synchronize()
        equal = (torch.equal(out, want[0][:, :, :B])
                 and torch.equal(cap, want[1][:, :B]))
        lanes = wavefront.fwd_block_lanes(n, CL)
        in_smem = wavefront.state_in_shared_memory(lanes, "affine")
        ms = chip_smoke.median_ms(run, runs=7)
        if B == 1 and in_smem:
            fit.append((lanes, ms * 1e3 / K))
        print(json.dumps({
            "kernel": "affine_fwd_block", "pairs": B, "cluster": CL,
            "lanes_per_block": lanes, "state_in_shared_memory": in_smem,
            "ms": ms, "us_per_diagonal": ms * 1e3 / K,
            "resident_clusters": wavefront._fwd_config(CL, n, dev)[0],
            "equal_to_plain": equal, "card": smi}), flush=True)
        failed += not equal
    x, y = np.array(fit).T
    slope, intercept = np.polyfit(x, y, 1)
    print(json.dumps({"fit": "us_per_diagonal = intercept + slope x lanes",
                      "kernel": "affine_fwd_block", "pairs": 1,
                      "points": len(fit), "ns_per_lane": slope * 1e3,
                      "intercept_us": intercept, "card": smi}), flush=True)
    return failed


def k7(wavefront, dev, smi: str) -> int:
    alpha, beta, sc, ck, (i, _, _) = block_state(wavefront, dev)
    n = alpha.shape[1]
    d0 = BLOCK * K
    state = ck[BLOCK].contiguous()
    want = wavefront.affine_bwd_window_reference(alpha, beta, state, d0, i,
                                                 sc, GO, GE, K)
    W = wavefront.window_width(n, K)
    failed = 0
    for pairs, CL, L in K7_CASES:
        plan = wavefront.bwd_window_plan(pairs, n, K, dev)
        L = plan["lanes_per_thread"] if L is None else L
        CL = plan["cluster"] if CL is None else CL
        resident, warps, passes = wavefront._bwd_config(W, CL, L, dev)[:3]
        al, be = alpha[:pairs].contiguous(), beta[:pairs].contiguous()
        st = state[:, :, :pairs].contiguous()
        ii = i[:pairs].contiguous()

        def run():
            return wavefront._bwd_window_launch(al, be, st, d0, ii, sc, GO,
                                                GE, K, CL, L)

        trace, wlo = run()
        torch.cuda.synchronize()
        equal = (torch.equal(trace, want[0][:, :pairs])
                 and torch.equal(wlo, want[1][:pairs]))
        ms = chip_smoke.median_ms(run, runs=7)
        print(json.dumps({
            "kernel": "affine_bwd_window", "pairs": pairs, "cluster": CL,
            "lanes_per_thread": L, "warps_per_block": warps,
            "passes": passes,
            "plan": (CL, L) == (plan["cluster"], plan["lanes_per_thread"]),
            "ms": ms, "us_per_diagonal": ms * 1e3 / K,
            "resident_clusters": resident, "equal_to_plain": equal,
            "card": smi}), flush=True)
        failed += not equal
    # one strip alone (a pair of 63 x 16,384, W = 64 lanes at 2 a thread,
    # from diagonal 4K, where every lane is inside the grid): the latency
    # of a warp-step with no edge to wait for
    d1 = 4 * K
    a1, b1 = alpha[:1, :63].contiguous(), beta[:1].contiguous()
    st1 = torch.zeros((3, 2, 1, 64), dtype=torch.int32, device=dev)
    i1 = torch.full((1,), 63, dtype=torch.int32, device=dev)

    def one():
        return wavefront._bwd_window_launch(a1, b1, st1, d1, i1, sc, GO, GE,
                                            K, 1, 2)

    equal = torch.equal(one()[0], wavefront.affine_bwd_window_reference(
        a1, b1, st1, d1, i1, sc, GO, GE, K)[0])
    ms = chip_smoke.median_ms(one, runs=7)
    print(json.dumps({"kernel": "affine_bwd_window", "pairs": 1, "n": 63,
                      "window_lanes": 64, "cluster": 1,
                      "lanes_per_thread": 2, "warps_per_block": 1, "ms": ms,
                      "us_per_diagonal": ms * 1e3 / K,
                      "cycles_per_diagonal_at_1980_MHz": ms * 1e-3 / K
                      * 1.98e9, "equal_to_plain": equal, "card": smi}),
          flush=True)
    return failed + (not equal)


def compare(wavefront, dev, smi: str, root: str) -> int:
    alpha, beta, sc, ck, walk_from = block_state(wavefront, dev)
    d0 = BLOCK * K
    state = ck[BLOCK]
    i = walk_from[0]

    def bwd():
        return wavefront.affine_bwd_window(alpha, beta, state, d0, i, sc, GO,
                                           GE, K)

    trace, wlo = wavefront.affine_bwd_window_reference(alpha, beta, state, d0,
                                                       i, sc, GO, GE, K)
    got = bwd()
    torch.cuda.synchronize()
    bwd_equal = torch.equal(got[0], trace) and torch.equal(got[1], wlo)
    want = [t.clone() for t in walk_from]
    ops_want = wavefront.lowmem_walk_block_reference(trace, wlo, d0, *want)
    have = [t.clone() for t in walk_from]
    ops = wavefront.lowmem_walk_block(trace, wlo, d0, *have)
    torch.cuda.synchronize()
    walk_equal = torch.equal(ops, ops_want) and all(
        torch.equal(g, w) for g, w in zip(have, want))

    def walk():
        # a fresh copy of the walk state each call (three 64-byte copies)
        return wavefront.lowmem_walk_block(trace, wlo, d0,
                                           *(t.clone() for t in walk_from))

    for name, fn, equal in (("affine_bwd_window", bwd, bwd_equal),
                            ("lowmem_walk_block", walk, walk_equal)):
        print(json.dumps({
            "kernel": name, "root": root,
            "ms_1_launch_a_sample": chip_smoke.median_ms(fn, runs=15),
            "ms_5_launches_a_sample": chip_smoke.median_ms(fn, runs=15,
                                                           inner=5),
            "equal_to_plain": equal, "card": smi}), flush=True)
    return (not bwd_equal) + (not walk_equal)


def main() -> int:
    parser = _timing.parser(__doc__, ("k6", "k7", "compare"))
    args = parser.parse_args()
    card = _timing.open_card(parser, args, "lowmem_timing")
    if card is None:
        return 1
    wavefront, dev, smi, root = card
    if args.mode == "compare":
        failed = compare(wavefront, dev, smi, root)
    else:
        failed = {"k6": k6, "k7": k7}[args.mode](wavefront, dev, smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
