#!/usr/bin/env python3
"""Where the two trace walks spend their time, on one CUDA card:
gsw_walk_pack (the graph aligner's, both sides of a wave) and
banded_walk_pack (the linear aligner's).

    python3 tools/walk_timing.py compare [--root DIR] [--jobs FILE]
    python3 tools/walk_timing.py plans [--jobs FILE]

The main shapes are those chip_smoke.py times: the graph walks on the
traces of the first 2048 left and 2048 right jobs of the graph phase's
warm-up waves, (n, m) = (192, 128) (tools/graph_timing.py `main_jobs`,
kept in FILE), and the banded walk on the kernels phase's batch of 4096
reads of 150 bp (chip_smoke.py `kernel_batch(1)`), each from the plain
DPs' traces and the plain walk's starts. Times are medians of CUDA
events; each case prints one JSON line with its time and whether its
result equals the plain version's.

Each kernel is timed in a CUDA graph, as chip_smoke.py's `graph_ms`
times it: a graph of 20 calls, replayed 15 times, the median per call;
a call launched eagerly costs the host tens of microseconds of Python
and ctypes, longer than these kernels, and the card may wait for it.

compare: both walks of a wave (and each side alone) and the banded walk
    through their public wrappers, in a graph (`graph_ms`) and eagerly
    (median of 15 samples of 5 launches, the banded walk 25 of 20, as
    chip_smoke.py's `ms` times them). With --root DIR the package is imported from the
    checkout at DIR (say a `git archive` of another commit in a
    git-ignored directory), so that two commits are timed the same way on
    one card: run parent, change, change, parent in one sitting.
plans: the graph walk and the banded walk on the main shapes and on
    traces of one code that set each warp's steps and rounds of loads
    (walk_rounds counts them on the plain walk's path): graph right walks
    from (192, 128) that stall on a 3 (D steps, one round) or move
    diagonally, left or up (then stall at j = 0 or i = 0), and one such
    walk alone (a step's latency with no other warp beside it); banded
    walks of up or diagonal moves from rows 150 and 64 and of left moves,
    and one read alone; then, per kernel, a least-squares fit of the time
    to a + rounds x r + steps x s over the synthetic cases of many warps,
    with rounds and steps those of the slowest warp: r is the time of a
    round of loads, s of a step.

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
import graph_timing  # noqa: E402

GAP = chip_smoke.GAP


def graph_walks(dev, jobs_path: str) -> dict:
    """{"left": (trace, corner, None, n_vec, m_vec), "right": (trace, bv,
    bd, None, None)}: the walks' inputs at the main shape, from the plain
    DPs."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    arrays = graph_timing.main_jobs(dev, jobs_path)
    left = graph_timing.on_card(arrays["left"], dev)
    right = graph_timing.on_card(arrays["right"], dev)
    _, _, ltrace, corner = wavefront.local_wavefront_reference(*left, sc,
                                                               GAP, True)
    bv, bd, rtrace = wavefront.gsw_right_wavefront_reference(*right, sc, GAP)
    return {"left": (ltrace, corner, None, left[2], left[3]),
            "right": (rtrace, bv, bd, None, None)}


def banded_walk(dev) -> tuple:
    """(trace, i_end, c_end, active, D) of the kernels phase's batch."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(dev)
                                 for x in chip_smoke.kernel_batch(1))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    bv, bi, trace = banded.banded_dp_reference(reads, wins, n_vec, m_vec, sc,
                                               GAP)
    score, i_star, c_star = banded.best_cell(bv, bi)
    return trace, i_star, c_star, score > 0, banded.walk_length(chip_smoke.L)


def compare(dev, smi: str, root: str, jobs_path: str) -> int:
    from gonomics_tpu_torch.ops import banded, gsw_dp

    walks = graph_walks(dev, jobs_path)
    failed = 0

    def row(kernel, shape, fn, want, runs, inner):
        nonlocal failed
        ok = _timing.equal(fn(), want)
        failed += not ok
        print(json.dumps({
            "kernel": kernel, "shape": shape, "root": root,
            "graph_ms": chip_smoke.graph_ms(fn, runs=15, inner=20),
            f"eager_ms_{inner}_launches_a_sample": chip_smoke.median_ms(
                fn, runs=runs, inner=inner),
            "equal_to_plain": ok, "card": smi}), flush=True)

    sides = ("left", "right")
    want = tuple(gsw_dp.gsw_walk_pack_reference(s, *walks[s]) for s in sides)
    row("gsw_walk_pack", "both walks of a wave: 2048 jobs a side at "
        "(192, 128)", lambda: tuple(gsw_dp.gsw_walk_pack(s, *walks[s])
                                    for s in sides), want, 15, 5)
    for s, w in zip(sides, want):
        row("gsw_walk_pack", f"{s} walks", lambda s=s: gsw_dp.gsw_walk_pack(
            s, *walks[s]), w, 15, 5)
    args = banded_walk(dev)
    row("banded_walk_pack", "4096 reads of 150 bp",
        lambda: banded.banded_walk_pack(*args),
        banded.banded_walk_pack_reference(*args), 25, 20)
    return failed


def _fit(cases: list) -> dict:
    """Least squares of ms to a + rounds r + steps s over the cases."""
    A = np.array([[1.0, c["rounds"], c["max_steps"]] for c in cases])
    y = np.array([c["ms"] for c in cases])
    (a, r, s), *_ = np.linalg.lstsq(A, y, rcond=None)
    return {"ms_fixed": a, "ms_per_round": r, "ms_per_step": s,
            "max_residual_ms": float(np.abs(A @ (a, r, s) - y).max())}


def _emit(rec: dict, smi: str):
    print(json.dumps({**rec, "card": smi}), flush=True)


def _time_cases(kernel: str, cases: list, run, plain, count, smi: str):
    """Each case (name, side, args) timed and checked, one JSON line each,
    then the fit over the cases of many warps; the count of failures."""
    failed = 0
    recs = []
    for name, side, args in cases:
        ok = _timing.equal(run(side, args), plain(side, args))
        failed += not ok
        steps, rounds = count(side, args)
        rec = {"kernel": kernel, "case": name, "side": side,
               "ms": chip_smoke.graph_ms(lambda: run(side, args)),
               "max_steps": int(steps.max()), "rounds": int(rounds.max()),
               "mean_steps": float(steps.float().mean()),
               "mean_rounds": float(rounds.float().mean()),
               "equal_to_plain": ok}
        recs.append(rec)
        _emit(rec, smi)
    _emit({"kernel": kernel, "fit": _fit(
        [r for r in recs if r["case"] != "main" and "alone" not in r["case"]
         ])}, smi)
    return failed


def plans(dev, smi: str, jobs_path: str) -> int:
    from gonomics_tpu_torch.ops import banded, gsw_dp

    walks = graph_walks(dev, jobs_path)
    D, C, S = walks["right"][0].shape
    n = S - 1
    # right walks from (n, D - n) over traces of one code, every job alike
    bv = torch.zeros((C, S), dtype=torch.int32, device=dev)
    bv[:, n] = 1
    bd = torch.full((C, S), D, dtype=torch.int32, device=dev)
    cases = [("main", s, walks[s]) for s in ("left", "right")]
    for name, code in (("stall", 3), ("diagonal", 0), ("left", 1), ("up", 2)):
        trace = torch.full((D, C, S), code, dtype=torch.int8, device=dev)
        cases.append((name, "right", (trace, bv, bd, None, None)))
    # one job alone: the latency of a step with no other warp beside it
    cases.append(("stall_alone", "right",
                  (cases[2][2][0][:, :1].contiguous(), bv[:1], bd[:1], None,
                   None)))
    failed = _time_cases(
        "gsw_walk_pack", cases, lambda side, a: gsw_dp.gsw_walk_pack(side, *a),
        lambda side, a: gsw_dp.gsw_walk_pack_reference(side, *a),
        lambda side, a: gsw_dp.walk_rounds(side, *a), smi)
    # banded: the main batch, then every read from (i, 63) over one code:
    # up and diagonal moves from i = L (L steps, rounds of 32 rows) and
    # from i = 64 (2 rounds), left moves (D steps in one tile), and one
    # read alone
    args = banded_walk(dev)
    trace, i_end, c_end, active, Db = args
    cases = [("main", None, args)] + [
        (name, None, (torch.full_like(trace, code),
                      torch.full_like(i_end, i0), torch.full_like(c_end, 63),
                      torch.ones_like(active), Db))
        for name, code, i0 in (("up", 2, chip_smoke.L),
                               ("diagonal", 0, chip_smoke.L),
                               ("diagonal_64", 0, 64), ("left", 1, 64))]
    left = cases[-1][2]
    cases.append(("left_alone", None, (left[0][:, :1].contiguous(),
                                       *(t[:1] for t in left[1:4]), Db)))
    failed += _time_cases(
        "banded_walk_pack", cases, lambda _, a: banded.banded_walk_pack(*a),
        lambda _, a: banded.banded_walk_pack_reference(*a),
        lambda _, a: banded.walk_rounds(*a), smi)
    return failed


def main() -> int:
    parser = _timing.parser(__doc__, ("compare", "plans"))
    parser.add_argument("--jobs",
                        default=os.path.join(ROOT, "gonomics_tpu_torch",
                                             "_build", "graph_jobs.npz"),
                        help="the graph main shape's jobs, built once and "
                             "kept")
    args = parser.parse_args()
    card = _timing.open_card(parser, args, "walk_timing")
    if card is None:
        return 1
    _, dev, smi, root = card
    if args.mode == "compare":
        failed = compare(dev, smi, root, args.jobs)
    else:
        failed = plans(dev, smi, args.jobs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
