#!/usr/bin/env python3
"""Where the graph aligner's extension DPs spend their time, on one CUDA
card: local_wavefront (K4, LeftDynamicAln) and gsw_right_wavefront (K5,
RightDynamicAln).

    python3 tools/graph_timing.py plans [--jobs FILE]
    python3 tools/graph_timing.py compare [--root DIR] [--jobs FILE]

Both modes work on the main shape chip_smoke.py times: the first 2048
left and 2048 right jobs of the graph phase's warm-up waves (gsw defaults
on the variant graph of a 50 Mbp chromosome, one batch of 2048 x 150 bp
reads), padded to the waves' widths, (n, m) = (192, 128) there; and on
2 jobs of a 10,300-base window with 32-base read parts (the wide
window). The jobs are built once and kept in FILE (an .npz; default
gonomics_tpu_torch/_build/graph_jobs.npz, git-ignored), so that every
process of a sitting times the same inputs. Times are medians of CUDA events; each case prints one
JSON line with its time and whether its result equals the plain
version's.

plans: K4 and K5 at the main shape at ``graph_dp_plan``'s plan, at every
    count L of slots a lane of the warp design that holds the read part
    (K5 sweeps L slots a lane; K4 takes m_b / 32 + 1 of them whatever L
    is), and at the block design (one block a job, a barrier a diagonal);
    one job alone (the widest) at the plan, whose time over its diagonals
    is the latency of a warp-step; the wide window at the plan. Median of
    15 samples of 5 launches (the wide window 5 of 1).
compare: K4 and K5 through their public wrappers at the main shape and at
    the wide window, the median of 15 samples of 5 launches. With --root
    DIR the package is imported from the checkout at DIR (say a `git
    archive` of another commit in a git-ignored directory), so that two
    commits are timed the same way on one card: run parent, change,
    change, parent in one sitting.

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

GAP = chip_smoke.GAP
KINDS = ("local", "gsw_right")


def main_jobs(dev, path: str) -> dict:
    """{"left": (al, be, nv, mv), "right": ...} numpy job arrays of the main
    shape, built from the graph phase's warm-up batch or read from path."""
    if os.path.exists(path):
        z = np.load(path)
        return {side: tuple(z[f"{side}_{k}"] for k in ("al", "be", "nv", "mv"))
                for side in ("left", "right")}
    from gonomics_tpu_torch.graph_align import GraphAligner

    g = chip_smoke.build_graph(chip_smoke.GRAPH_BP, 5)
    al = GraphAligner(g, device=dev)
    reads = chip_smoke.graph_reads(g, chip_smoke.GRAPH_BATCH, 200, "g")[0]
    waves, start_wave = [], al.dp.start_wave

    def record(*args):
        waves.append(args)
        return start_wave(*args)

    al.dp.start_wave = record
    al.finish_batch(al.align_batch_async(reads))
    out = {}
    for name, side in (("left", 0), ("right", 4)):
        out[name] = chip_smoke.stack_jobs(waves, side, chip_smoke.GRAPH_JOBS,
                                          al.dp._dims[name])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"{side}_{k}": np.ascontiguousarray(x)
                      for side, arrs in out.items()
                      for k, x in zip(("al", "be", "nv", "mv"), arrs)})
    return out


def on_card(arrays, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in arrays)


def kernel_calls(wavefront, kind: str, jobs, sc):
    """The wrapper and the plain version of K4 (with the corner, as the
    main path calls it) or K5 on jobs."""
    if kind == "local":
        return (lambda: wavefront.local_wavefront(*jobs, sc, GAP, True),
                lambda: wavefront.local_wavefront_reference(*jobs, sc, GAP,
                                                            True))
    return (lambda: wavefront.gsw_right_wavefront(*jobs, sc, GAP),
            lambda: wavefront.gsw_right_wavefront_reference(*jobs, sc, GAP))


def plans(wavefront, dev, smi: str, jobs_path: str) -> int:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    arrays = main_jobs(dev, jobs_path)
    failed = 0
    cases = []
    for kind, side in zip(KINDS, ("left", "right")):
        jobs = on_card(arrays[side], dev)
        C, n = jobs[0].shape
        m = jobs[1].shape[1]
        base = wavefront.graph_dp_plan(C, n, m, kind)
        forced = [{**base, "slots_per_lane": L}
                  for L in wavefront._graph_built()["slots"]
                  if 32 * L >= m + 1 and L != base["slots_per_lane"]]
        # the block design, as before the warp design
        forced.append(wavefront.graph_dp_plan(C, n, 100_000, kind))
        for plan in [base] + forced:
            cases.append((kind, "main", jobs, plan, plan is base, 5))
        # one job alone, the one with the most cells of its own grid
        nv, mv = arrays[side][2], arrays[side][3]
        b = int(np.argmax(nv.astype(np.int64) * mv))
        one = tuple(t[b:b + 1].contiguous() for t in jobs)
        cases.append((kind, "one_job", one,
                      wavefront.graph_dp_plan(1, n, m, kind), True, 5))
        wide = chip_smoke.wide_window_jobs(kind == "local", dev)
        wplan = wavefront.graph_dp_plan(len(wide[2]), wide[0].shape[1],
                                        wide[1].shape[1], kind)
        cases.append((kind, "wide_window", wide, wplan, True, 1))
    for kind, shape, jobs, plan, is_plan, inner in cases:
        C, n = jobs[0].shape
        m = jobs[1].shape[1]
        with_corner = kind == "local"

        def run():
            return wavefront._graph_launch(kind, *jobs, sc, GAP, with_corner,
                                           plan)

        want = kernel_calls(wavefront, kind, jobs, sc)[1]()
        ok = _timing.equal(run(), want)
        ms = chip_smoke.median_ms(run, runs=15 if inner > 1 else 5,
                                  inner=inner)
        print(json.dumps({
            "kernel": ("local_wavefront" if kind == "local"
                       else "gsw_right_wavefront"),
            "shape": shape, "jobs": C, "n": n, "m": m, "plan": plan,
            "is_wrapper_plan": is_plan, "ms": ms,
            "us_per_diagonal": ms * 1e3 / (n + m),
            "cycles_per_diagonal_at_1980_MHz": ms * 1e-3 / (n + m) * 1.98e9,
            "equal_to_plain": ok, "card": smi}), flush=True)
        failed += not ok
    return failed


def compare(wavefront, dev, smi: str, root: str, jobs_path: str) -> int:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    arrays = main_jobs(dev, jobs_path)
    failed = 0
    for kind, side in zip(KINDS, ("left", "right")):
        for shape, jobs in (
                ("main", on_card(arrays[side], dev)),
                ("wide_window",
                 chip_smoke.wide_window_jobs(kind == "local", dev))):
            kernel, plain = kernel_calls(wavefront, kind, jobs, sc)
            ok = _timing.equal(kernel(), plain())
            print(json.dumps({
                "kernel": ("local_wavefront" if kind == "local"
                           else "gsw_right_wavefront"),
                "shape": shape, "jobs": len(jobs[2]),
                "n": jobs[0].shape[1], "m": jobs[1].shape[1], "root": root,
                "ms_5_launches_a_sample": chip_smoke.median_ms(
                    kernel, runs=15, inner=5),
                "equal_to_plain": ok, "card": smi}), flush=True)
            failed += not ok
    return failed


def main() -> int:
    parser = _timing.parser(__doc__, ("plans", "compare"))
    parser.add_argument("--jobs",
                        default=os.path.join(ROOT, "gonomics_tpu_torch",
                                             "_build", "graph_jobs.npz"),
                        help="the main shape's jobs, built once and kept")
    args = parser.parse_args()
    card = _timing.open_card(parser, args, "graph_timing")
    if card is None:
        return 1
    wavefront, dev, smi, root = card
    if args.mode == "compare":
        failed = compare(wavefront, dev, smi, root, args.jobs)
    else:
        failed = plans(wavefront, dev, smi, args.jobs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
