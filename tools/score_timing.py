#!/usr/bin/env python3
"""Where the score-only kernels affine_stream (K8) and affine_score_diag
(K2's score mode and K9's contract) spend their time, on one CUDA card.

    python3 tools/score_timing.py plans
    python3 tools/score_timing.py compare [--root DIR]
    python3 tools/score_timing.py sass

The main shapes are those chip_smoke.py times, humanChimpTwo, gaps
-600/-150: for K8 bench.py's stream batch, P = 8 x B = 256 random pairs of
1024 x 1024 (seeds 0 and 1); for K2's score mode the 256 related pairs
padded to 1024 x 1024 of its pairwise_kernels phase; for K9 the 256
related pairs of its score_kernels phase at r_rows = 512. Times are
medians of CUDA events; each case prints one JSON line with its time and
whether its result equals the plain version's.

plans: K8 at every count R of rows a lane it is built for, each with the
    launch its library reports (registers, spilled bytes, blocks an SM
    holds), at its main shape (median of 15 samples of 2 launches) and on
    one pair alone (median of 15 samples of 5 launches), whose time over
    its steps is the latency of a warp-step; then affine_score_diag at
    every R and at 1, 2, 4, 8 and 16 warps a pair, at K2's and K9's main
    shapes and on one pair alone, marking the plan the wrappers take.
compare: K8, K2's score mode and K9 through their public wrappers at their
    main shapes, the median of 15 samples of 2 launches; then, as
    chip_smoke.py's lowmem phase times it (`k2_score_mode_s`, the host's
    clock around one call of the pairwise API without cigars), K2's score
    mode on bench.py's lowmem batch (16 pairs of 16,384 x 16,384) and on
    the phase's related 100 kb pair, with a checksum of the scores. With
    --root DIR
    the package is imported from the checkout at DIR (say a `git archive`
    of another commit in a git-ignored directory), so that two commits
    are timed the same way on one card: run parent, change, change,
    parent in one sitting.
sass: compiles csrc/wavefront.cu to a cubin with `nvcc -Xptxas -v`
    (registers, spills) and counts, in `cuobjdump -sass` of each
    affine_stream_kernel<R>, affine_score_diag_kernel<R> and
    trace_diag_kernel<R, mode> (mode 0 K2's trace mode, 1 K3's trace mode,
    2 K3's score mode), the instructions of its longest straight run (the
    block of R steps that needs no edge test) by opcode, and per step.

Needs a CUDA card (sass needs only nvcc and cuobjdump); the package builds
its kernels into the git-ignored gonomics_tpu_torch/_build/ of the
checkout it is imported from.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import _timing  # noqa: E402
import chip_smoke  # noqa: E402

GO, GE = chip_smoke.AFFINE_GAPS


def score_batches(dev) -> dict:
    """K2's and K9's main shapes: (alpha, beta, fin, rows, r_rows, nb)."""
    L, R = chip_smoke.SCORE_L, chip_smoke.SCORE_R
    k2 = chip_smoke.pair_batch(chip_smoke.PAIR_B_SCORE, chip_smoke.PAIR_LEN,
                               chip_smoke.PAIR_LEN,
                               seed=chip_smoke.PAIR_B_SCORE + len("affine"),
                               dev=dev)[:3]
    k9 = chip_smoke.pair_batch(chip_smoke.SCORE_B, L, L, seed=41, dev=dev)[:3]
    nb = -(-L // R)
    return {"k2_score_mode": (*k2, chip_smoke.PAIR_LEN, chip_smoke.PAIR_LEN, 1),
            "k9": (*k9, nb * R, R, nb)}


def plans(wavefront, dev, smi: str) -> int:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    sa, sb = chip_smoke.stream_batch(dev)
    P, B, n = sa.shape
    m = sb.shape[2]
    want = wavefront.affine_stream_reference(sa, sb, sc, GO, GE)
    main = wavefront.stream_launch_plan(P * B, n, m)
    failed = 0
    for R in wavefront._stream_built()["rows_per_lane"]:
        for shape, (a, b, w, inner) in (
                ("main", (sa, sb, want, 2)),
                ("one_pair", (sa[:1, :1].contiguous(), sb[:1, :1].contiguous(),
                              want[:1, :1], 5))):
            pairs = a.shape[0] * a.shape[1]
            plan = wavefront.stream_launch_plan(pairs, n, m, R)
            out = torch.empty(a.shape[:2], dtype=torch.int32, device=dev)

            def run():
                return wavefront._stream_launch(a, b, sc, GO, GE, plan, out)

            ok = _timing.equal(run().clone(), w)
            ms = chip_smoke.median_ms(run, runs=15, inner=inner)
            # the steps to cell (n, m): whole strips, then row n's of the last
            last = n - 1 - (plan["strips"] - 1) * plan["strip_rows"]
            steps = (plan["strips"] - 1) * plan["steps_a_strip"] + last + m
            print(json.dumps({
                "kernel": "affine_stream", "shape": shape, "pairs": pairs,
                "n": n, "m": m, "plan": plan,
                "is_wrapper_plan": R == main["rows_per_lane"], "ms": ms,
                "g_cells_per_s": pairs * n * m / ms / 1e6,
                "us_per_step": ms * 1e3 / steps,
                "cycles_per_step_at_1980_MHz": ms * 1e-3 / steps * 1.98e9,
                "equal_to_plain": ok, "card": smi}), flush=True)
            failed += not ok
    for name, (a, b, f, rows, Rb, nb) in score_batches(dev).items():
        want = (wavefront.affine_block_reference(a, b, f, sc, GO, GE, Rb)
                if name == "k9" else wavefront.affine_wavefront_reference(
                    a, b, f, sc, GO, GE, False)[None])
        m = b.shape[1]
        main = wavefront.score_diag_launch_plan(a.shape[0], rows, m)
        for shape, sel in (("main", slice(None)), ("one_pair", slice(0, 1))):
            pa, pb, pf = a[sel].contiguous(), b[sel].contiguous(), f[sel]
            pw = want[:, sel].contiguous()
            pairs = pa.shape[0]
            for R in wavefront._score_diag_built()["rows_per_lane"]:
                for W in (1, 2, 4, 8, 16):
                    plan = wavefront.score_diag_launch_plan(pairs, rows, m, R, W)
                    out = torch.empty_like(pw)

                    def run():
                        return wavefront._score_diag_launch(
                            pa, pb, pf, sc, GO, GE, rows, Rb, nb, plan, out)

                    ok = _timing.equal(run().clone(), pw)
                    ms = chip_smoke.median_ms(run, runs=15,
                                              inner=2 if pairs > 1 else 5)
                    cells = chip_smoke.diagonal_cells(rows, m, pf.cpu().numpy())
                    print(json.dumps({
                        "kernel": "affine_score_diag", "caller": name,
                        "shape": shape, "pairs": pairs, "rows": rows, "m": m,
                        "plan": plan,
                        "is_wrapper_plan": shape == "main" and (R, W) == (
                            main["rows_per_lane"], main["warps_per_pair"]),
                        "ms": ms, "g_cells_per_s": cells / ms / 1e6,
                        "equal_to_plain": ok, "card": smi}), flush=True)
                    failed += not ok
    return failed


def compare(wavefront, dev, smi: str, root: str) -> int:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    sa, sb = chip_smoke.stream_batch(dev)
    P, B, n = sa.shape
    m = sb.shape[2]

    def kernel():
        return wavefront.wavefront_affine_stream(sa, sb, sc, n=n, m=m,
                                                 gap_open=GO, gap_extend=GE)

    ok = _timing.equal(kernel(), wavefront.affine_stream_reference(
        sa, sb, sc, GO, GE))
    ms = chip_smoke.median_ms(kernel, runs=15, inner=2)
    print(json.dumps({
        "kernel": "affine_stream", "shape": "main", "pairs": P * B, "n": n,
        "m": m, "root": root, "ms_2_launches_a_sample": ms,
        "g_cells_per_s": P * B * n * m / ms / 1e6,
        "equal_to_plain": ok, "card": smi}), flush=True)
    failed = not ok
    for name, (a, b, f, rows, Rb, nb) in score_batches(dev).items():
        m = b.shape[1]
        if name == "k9":
            def call(a=a, b=b, f=f, m=m, Rb=Rb):
                return wavefront.wavefront_align_blocked(
                    a, b, f, sc, n=a.shape[1], m=m, gap_open=GO,
                    gap_extend=GE, r_rows=Rb)
            want = wavefront.affine_block_reference(a, b, f, sc, GO, GE, Rb)
        else:
            def call(a=a, b=b, f=f):
                return wavefront.affine_wavefront(a, b, f, sc, GO, GE, False)
            want = wavefront.affine_wavefront_reference(a, b, f, sc, GO, GE,
                                                        False)
        ok = _timing.equal(call(), want)
        ms = chip_smoke.median_ms(call, runs=15, inner=2)
        cells = chip_smoke.diagonal_cells(rows, m, f.cpu().numpy())
        print(json.dumps({
            "kernel": name, "shape": "main", "pairs": a.shape[0], "rows": rows,
            "m": m, "root": root, "ms_2_launches_a_sample": ms,
            "g_cells_per_s": cells / ms / 1e6, "equal_to_plain": ok,
            "card": smi}), flush=True)
        failed += not ok
    from gonomics_tpu_torch import align
    H = align.HUMAN_CHIMP_TWO
    alphas, betas = chip_smoke.lowmem_pairs()
    long_pair = chip_smoke.related_pair(np.random.default_rng(37),
                                        chip_smoke.LOWMEM_LONG,
                                        same_length=False)
    for name, pairs in (("lowmem_batch", list(zip(alphas, betas))),
                        ("long_pair", [long_pair])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = align.affine_gap_batch(pairs, H, GO, GE, device=dev,
                                     with_cigar=False)
        secs = time.perf_counter() - t0
        print(json.dumps({
            "kernel": "k2_score_mode", "shape": name, "pairs": len(pairs),
            "n": len(pairs[0][0]), "m": len(pairs[0][1]), "root": root,
            "k2_score_mode_s": secs,
            "score_sum": int(sum(s for s, _ in res)), "card": smi}),
            flush=True)
    return 1 if failed else 0


def sass() -> int:
    """ptxas's report and the SASS instruction counts of each kernel with
    R rows a lane."""
    from gonomics_tpu_torch import _buildlib
    from gonomics_tpu_torch.ops import _kernels

    src = os.path.join(ROOT, "gonomics_tpu_torch", "csrc", "wavefront.cu")
    os.makedirs(_buildlib.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_buildlib.BUILD_DIR, "wavefront_sass.cubin")
    flags = [f for f in _kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    res = subprocess.run([_kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v",
                          "-o", cubin, src], check=True, capture_output=True,
                         text=True)
    lines = res.stderr.splitlines()
    kernels = ("affine_stream_kernel", "affine_score_diag_kernel",
               "trace_diag_kernel")
    for k, line in enumerate(lines):
        if any(x in line for x in kernels) and "Compiling" in line:
            print(json.dumps({"ptxas": lines[k:k + 4]}), flush=True)
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", dump)
    for body in funcs[1:]:
        name = body.split("\n", 1)[0].strip()
        kernel = next((x for x in kernels if x in name), None)
        if kernel is None:
            continue
        args = re.findall(r"Li(\d+)E", name.split(kernel, 1)[1])
        runs, cur, total = [], [], 0
        for line in body.splitlines():
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                           line)
            if line.strip().startswith(".L_"):
                runs.append(cur)
                cur = []
            if not ins:
                continue
            op = ins.group(2)
            total += 1
            cur.append(op)
            if op.startswith(("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC")):
                runs.append(cur)
                cur = []
        runs.append(cur)
        run = max(runs, key=len)
        ops = collections.Counter(o.split(".")[0] for o in run)
        print(json.dumps({
            "kernel": f"{kernel}<{', '.join(args)}>", "instructions": total,
            "longest_straight_run": len(run),
            "run_instructions_a_step": len(run) / int(args[0]),
            "run_by_opcode": dict(ops.most_common())}), flush=True)
    return 0


def main() -> int:
    parser = _timing.parser(__doc__, ("plans", "compare", "sass"))
    args = parser.parse_args()
    if args.mode == "sass":
        return sass()
    card = _timing.open_card(parser, args, "score_timing")
    if card is None:
        return 1
    wavefront, dev, smi, root = card
    if args.mode == "compare":
        failed = compare(wavefront, dev, smi, root)
    else:
        failed = plans(wavefront, dev, smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
