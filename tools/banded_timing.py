#!/usr/bin/env python3
"""Where the linear aligner's device step spends its time, on one CUDA
card: banded_dp (the DP kernel's trace mode), banded_align_full (the main
path's device step: the fused mode in one launch where banded_plan says it
fits, else banded_dp, best_cell and banded_walk_pack) and banded_walk_pack.

    python3 tools/banded_timing.py compare [--root DIR]
    python3 tools/banded_timing.py plans

The main shape is the one chip_smoke.py times: its kernels phase's batch
of 4096 reads of 150 bp in 198 bp windows (chip_smoke.py
`kernel_batch(1)`), humanChimpTwo, gap -600. Each case prints one JSON
line with its times, whether its result equals the plain version's, and
the card's name and power limit as nvidia-smi gives them.

compare: banded_dp, banded_align_full and banded_walk_pack (from the
    plain DP's trace and the plain best cells) through their public
    wrappers, in a CUDA graph (`graph_ms`: a graph of 20 calls replayed 15
    times, the median per call, as chip_smoke.py's `graph_ms`) and
    eagerly (the median of 25 samples of 20 launches, as chip_smoke.py's
    `ms`). With --root DIR the package is imported from the checkout at DIR
    (say a `git archive` of another commit in a git-ignored directory), so
    that two commits are timed the same way on one card: run parent,
    change, change, parent in one call.
plans: the DP kernel at every lane count a thread it is built for and 1-8
    warps a block (each that fits shared memory), in a graph, each with its
    launch as the library reports it (registers, spilled bytes, shared
    memory, the blocks an SM holds), at the shapes of PLAN_SHAPES, each in
    the modes its reads can take; then, a line a shape and mode, the plan
    banded_plan gives it beside the fastest case.

Needs a CUDA card; the package builds its kernels into the git-ignored
gonomics_tpu_torch/_build/ of the checkout it is imported from.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import _timing  # noqa: E402
import chip_smoke  # noqa: E402


# (reads, read length, modes) the plans are timed at: the main path's
# batch (chip_smoke.py's), the CLI's default batch (`gsw align --batch
# 2048`) and a small batch, all on the fused mode where the trace fits
# shared memory (the trace mode as well at the main batch, for the
# record); and long reads, whose traces do not fit, on the trace mode, in
# chip_smoke.py's long-read batch of 64 and in a batch of 1024
PLAN_SHAPES = ((4096, 150, ("fused", "dp")), (2048, 150, ("fused",)),
               (400, 150, ("fused",)), (64, 13_000, ("dp",)),
               (1024, 13_000, ("dp",)))


def main_batch(dev, B: int = chip_smoke.B, L: int = chip_smoke.L) -> tuple:
    """(reads, windows, n_vec, m_vec, scores, gap) of the kernels phase's
    batch (chip_smoke.py `kernel_batch(1)`), or of one like it of B reads
    of L."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(dev)
                                 for x in chip_smoke.kernel_batch(1, B, L))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    return reads, wins, n_vec, m_vec, sc, chip_smoke.GAP


def _emit(rec: dict, smi: str):
    print(json.dumps({**rec, "card": smi}), flush=True)


def compare(dev, smi: str, root: str) -> int:
    from gonomics_tpu_torch.ops import banded

    args = main_batch(dev)
    bv, bi, trace = banded.banded_dp_reference(*args)
    score, i_star, c_star = banded.best_cell(bv, bi)
    walk = (trace, i_star, c_star, score > 0,
            banded.walk_length(chip_smoke.L))
    i0, c0, packed = banded.banded_walk_pack_reference(*walk)
    full_want = (score, i_star, i_star + c_star, i0, i0 + c0, packed)
    failed = 0
    for kernel, fn, want in (
            ("banded_dp", lambda: banded.banded_dp(*args), (bv, bi, trace)),
            ("banded_align_full", lambda: banded.banded_align_full(*args),
             full_want),
            ("banded_walk_pack", lambda: banded.banded_walk_pack(*walk),
             (i0, c0, packed))):
        ok = _timing.equal(fn(), want)
        failed += not ok
        _emit({"kernel": kernel, "shape": "4096 reads of 150 bp",
               "root": root, "graph_ms": chip_smoke.graph_ms(fn),
               "eager_ms": chip_smoke.median_ms(fn, inner=20),
               "equal_to_plain": ok}, smi)
    return failed


def plans(dev, smi: str) -> int:
    from gonomics_tpu_torch.ops import banded

    built = banded._banded_built(dev)
    _emit({"built": built}, smi)
    failed = 0
    for B, L, modes in PLAN_SHAPES:
        args = main_batch(dev, B, L)
        # fewer calls a sample where a call takes milliseconds
        runs, inner = (15, 20) if L <= 1000 else (5, 3)
        for mode in modes:
            want = (banded.banded_align_full_reference if mode == "fused"
                    else banded.banded_dp_reference)(*args)
            cases = []
            for R in built["lanes_per_thread"]:
                for WB in range(1, built["max_warps"] + 1):
                    try:
                        plan = banded.banded_launch_plan(B, L, mode, R, WB)
                    except ValueError:  # its shared memory does not fit
                        continue

                    def fn(plan=plan):
                        return banded._banded_launch(plan, *args)
                    ok = _timing.equal(fn(), want)
                    failed += not ok
                    rec = {"B": B, "L": L, "mode": mode,
                           "lanes_per_thread": R, "warps_per_block": WB,
                           "graph_ms": chip_smoke.graph_ms(fn, runs, inner),
                           "equal_to_plain": ok, "plan": plan}
                    cases.append(rec)
                    _emit(rec, smi)
            main = banded.banded_launch_plan(B, L, mode)
            best = min(cases, key=lambda r: r["graph_ms"])
            chosen = [r["graph_ms"] for r in cases
                      if (r["lanes_per_thread"], r["warps_per_block"])
                      == (main["lanes_per_thread"], main["warps_per_block"])]
            _emit({"B": B, "L": L, "mode": mode,
                   "main_plan": {k: main[k] for k in (
                       "lanes_per_thread", "warps_per_block")},
                   "main_plan_graph_ms": chosen[0] if chosen else None,
                   "fastest": {k: best[k] for k in (
                       "lanes_per_thread", "warps_per_block", "graph_ms")}},
                  smi)
            del want
        del args
    return failed


def main() -> int:
    parser = _timing.parser(__doc__, ("compare", "plans"))
    args = parser.parse_args()
    card = _timing.open_card(parser, args, "banded_timing")
    if card is None:
        return 1
    _, dev, smi, root = card
    failed = compare(dev, smi, root) if args.mode == "compare" else \
        plans(dev, smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
