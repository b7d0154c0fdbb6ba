#!/usr/bin/env python3
"""Where the pairwise aligner's wavefront kernel trace_diag (K2's trace
mode, K3 in both modes) spends its time, on one CUDA card.

    python3 tools/pairwise_timing.py plans [--mode MODE] [--rows R] [--warps W]
    python3 tools/pairwise_timing.py compare [--root DIR]

The main shapes are those chip_smoke.py's pairwise_kernels phase times:
128 related pairs padded to 1024 x 1024 with trace (seed 128 + 6 for K2,
128 + 5 for K3) and 256 in K3's score mode (seed 256 + 5), HUMAN_CHIMP_TWO,
affine gaps -600/-150, linear gap -430. Times are medians of CUDA events;
each case prints one JSON line with its time and whether its result
equals the plain version's.

plans: trace_diag at every count R of rows a lane it is built for in the
    mode and at 1, 2, 4 and 8 warps a pair, each with the launch its
    library reports (registers, spilled bytes, blocks an SM holds), at
    each main shape
    (median of 15 samples of 2 launches) and on one pair alone (15 of 5),
    marking the plan the wrappers take; the time over the pipeline's
    critical path in steps (at one warp a pair or a warp a strip) is the
    latency of a warp-step. --mode (affine, const or const_score),
    --rows and --warps keep one of each.
compare: K2's trace mode, K3's trace and score modes through their public
    wrappers at the main shapes (median of 15 samples of 2 launches, and
    the device memory one call allocates above its inputs), and
    the pairwise phase of chip_smoke.py: affine_gap_batch and
    const_gap_batch with routes on its 128 related ~1 kb pairs, the wall
    and its kernel_ms (the wavefront call on the card's clock) as that
    phase splits them, median of 5 calls. With --root DIR the package is
    imported from the checkout at DIR (say a `git archive` of another
    commit in a git-ignored directory), so that two commits are timed the
    same way on one card: run parent, change, change, parent in one
    sitting.

Needs a CUDA card; the package builds its kernels into the git-ignored
gonomics_tpu_torch/_build/ of the checkout it is imported from.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import _timing  # noqa: E402
import chip_smoke  # noqa: E402

GAPS = {"affine": chip_smoke.AFFINE_GAPS, "const": (chip_smoke.CONST_GAP, 0),
        "const_score": (chip_smoke.CONST_GAP, 0)}


def main_batches(dev) -> dict:
    """mode -> (alpha, beta, fin) of its main shape, as pairwise_kernels
    builds them."""
    L = chip_smoke.PAIR_LEN
    out = {}
    for mode, B in (("affine", chip_smoke.PAIR_B_TRACE),
                    ("const", chip_smoke.PAIR_B_TRACE),
                    ("const_score", chip_smoke.PAIR_B_SCORE)):
        seed = B + len(mode.split("_")[0])
        out[mode] = chip_smoke.pair_batch(B, L, L, seed=seed, dev=dev)[:3]
    return out


def wrapper(wavefront, mode, sc):
    """The public call of ``mode`` and its plain version."""
    go, ge = GAPS[mode]
    if mode == "affine":
        return (lambda a, b, f: wavefront.affine_wavefront(a, b, f, sc, go,
                                                           ge, True),
                lambda a, b, f: wavefront.affine_wavefront_reference(
                    a, b, f, sc, go, ge, True))
    tr = mode == "const"
    return (lambda a, b, f: wavefront.const_wavefront(a, b, f, sc, go, tr),
            lambda a, b, f: wavefront.const_wavefront_reference(a, b, f, sc,
                                                                go, tr))


def plans(wavefront, dev, smi: str, only: dict) -> int:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    failed = 0
    for mode, (a, b, f) in main_batches(dev).items():
        if only["mode"] not in (None, mode):
            continue
        built = wavefront._trace_diag_built(mode)
        n, m = a.shape[1], b.shape[1]
        want = wrapper(wavefront, mode, sc)[1](a, b, f)
        want = want if isinstance(want, tuple) else (want,)
        main = wavefront.trace_diag_launch_plan(a.shape[0], n, m, mode)
        go, ge = GAPS[mode]
        for shape, sel in (("main", slice(None)), ("one_pair", slice(0, 1))):
            pa, pb, pf = a[sel].contiguous(), b[sel].contiguous(), f[sel]
            pw = [w[sel] if w.shape[0] == a.shape[0] else w[:, sel]
                  for w in want]
            pairs = pa.shape[0]
            for R in built["rows_per_lane"]:
                for W in (1, 2, 4, 8):
                    if only["rows"] not in (None, R) or \
                            only["warps"] not in (None, W):
                        continue
                    plan = wavefront.trace_diag_launch_plan(pairs, n, m, mode,
                                                            R, W)
                    res = [torch.empty_like(pw[0])
                           for _ in range(3 if mode == "affine" else 1)]

                    def run():
                        return wavefront._trace_diag_launch(
                            mode, pa, pb, pf, sc, go, ge, plan, res)

                    trace = run()
                    got = tuple(res) + ((trace,) if trace is not None else ())
                    ok = _timing.equal(got, tuple(pw))
                    ms = chip_smoke.median_ms(run, runs=15,
                                              inner=2 if pairs > 1 else 5)
                    # the critical path in steps, at one warp a pair (the
                    # strips in turn) or a warp a strip (each strip 34
                    # blocks of R steps behind the one before): the strips
                    # before the last, then the last one's steps
                    strips = plan["strips"]
                    before = (strips - 1) * (m + 32 * R - 1 if W == 1
                                             else 34 * R)
                    path = (before + m + n - 1 - (strips - 1) * 32 * R
                            if W == 1 or W >= strips else None)
                    print(json.dumps({
                        "kernel": "trace_diag", "mode": mode, "shape": shape,
                        "pairs": pairs, "n": n, "m": m, "plan": plan,
                        "is_wrapper_plan": shape == "main" and (R, W) == (
                            main["rows_per_lane"], main["warps_per_pair"]),
                        "ms": ms, "critical_path_steps": path,
                        "cycles_per_step_at_1980_MHz":
                            ms * 1e-3 / path * 1.98e9 if path else None,
                        "equal_to_plain": ok, "card": smi}), flush=True)
                    failed += not ok
    return failed


def related_pairs():
    """chip_smoke.py's pairwise phase: 128 related pairs of ~1 kb."""
    rng = np.random.default_rng(17)
    return [chip_smoke.related_pair(rng, chip_smoke.RELATED_LEN,
                                    same_length=False)
            for _ in range(chip_smoke.RELATED_PAIRS)]


def compare(wavefront, dev, smi: str, root: str) -> int:
    from gonomics_tpu_torch import align
    from gonomics_tpu_torch.align import pairwise
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    failed = 0
    for mode, (a, b, f) in main_batches(dev).items():
        call, plain = wrapper(wavefront, mode, sc)
        ok = _timing.equal(call(a, b, f), plain(a, b, f))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = call(a, b, f)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        del out
        ms = chip_smoke.median_ms(lambda: call(a, b, f), runs=15, inner=2)
        print(json.dumps({
            "kernel": {"affine": "k2_trace", "const": "k3_trace",
                       "const_score": "k3_score"}[mode],
            "shape": "main", "pairs": a.shape[0], "n": a.shape[1],
            "m": b.shape[1], "root": root, "ms_2_launches_a_sample": ms,
            "peak_above_inputs_bytes": peak, "equal_to_plain": ok,
            "card": smi}), flush=True)
        failed += not ok
    pairs = related_pairs()
    H = align.HUMAN_CHIMP_TWO
    calls = {"affine": lambda: align.affine_gap_batch(
                 pairs, H, *chip_smoke.AFFINE_GAPS, device=dev),
             "const": lambda: align.const_gap_batch(
                 pairs, H, chip_smoke.CONST_GAP, device=dev)}
    inner = pairwise.wavefront_align
    kernel_ms = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        end.synchronize()
        kernel_ms.append(start.elapsed_time(end))
        return out

    pairwise.wavefront_align = timed
    try:
        for mode, fn in calls.items():
            fn()  # warm-up
            walls, kernels, check = [], [], None
            for _ in range(5):
                kernel_ms.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                walls.append((time.perf_counter() - t0) * 1e3)
                kernels.append(sum(kernel_ms))
                check = sum(s for s, _ in res), sum(len(r) for _, r in res)
            print(json.dumps({
                "kernel": f"pairwise_{mode}", "pairs": len(pairs),
                "root": root, "wall_ms": float(np.median(walls)),
                "kernel_ms": float(np.median(kernels)),
                "pairs_per_s": len(pairs) / float(np.median(walls)) * 1e3,
                "score_sum": int(check[0]), "cigar_runs": int(check[1]),
                "card": smi}), flush=True)
    finally:
        pairwise.wavefront_align = inner
    return failed


def main() -> int:
    parser = _timing.parser(__doc__, ("plans", "compare"))
    parser.add_argument("--mode", dest="only_mode", choices=tuple(GAPS),
                        help="plans: this mode only")
    parser.add_argument("--rows", type=int, help="plans: this R only")
    parser.add_argument("--warps", type=int, help="plans: this W only")
    args = parser.parse_args()
    card = _timing.open_card(parser, args, "pairwise_timing")
    if card is None:
        return 1
    wavefront, dev, smi, root = card
    if args.mode == "compare":
        failed = compare(wavefront, dev, smi, root)
    else:
        failed = plans(wavefront, dev, smi, {"mode": args.only_mode,
                                              "rows": args.rows,
                                              "warps": args.warps})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
