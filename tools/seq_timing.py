#!/usr/bin/env python3
"""Where the sequence-sharded aligner's forward spends its time, on the
card or across several cards: ``parallel.shard_seq_forward`` (strips of
lanes, a CUDA stream a strip, K6's strip mode) against the unsharded
``ops.wavefront.lowmem_forward`` on the same inputs.

    python3 tools/seq_timing.py forward [--repeats N]

Two inputs: bench.py's lowmem batch (16 pairs of 16,384 x 16,384, K =
1024) and chip_smoke.py's related 100 kb pair (K = 4096). Each is run
unsharded, then at seq = 2 and 4 on a mesh that repeats the first card
and, where the machine has that many cards, on a mesh of distinct cards;
N rounds (default 3), the order of the cases turned each round. A case's
time is the card's clock from a synchronised start to the end of the
forward on the first card, whose stream waits for every strip; its
checkpoints are held against the unsharded forward's once, started while
that forward is still queued on the first card. One JSON line
a case and round, then a line a case and input with the median. Last,
one traced run of each sharded case (torch.profiler) gives the strips'
kernel time, the span in which any of them ran and their ratio, the mean
number of strips running at once.

Needs a CUDA card; the package builds its kernels into the git-ignored
gonomics_tpu_torch/_build/ of this checkout.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import _timing  # noqa: E402
import chip_smoke  # noqa: E402

GO, GE = chip_smoke.AFFINE_GAPS


def inputs(dev):
    """(name, alpha, beta, K) of the two inputs, on ``dev``."""
    a, b = chip_smoke.lowmem_pairs()
    la, lb = chip_smoke.related_pair(np.random.default_rng(37),
                                     chip_smoke.LOWMEM_LONG,
                                     same_length=False)
    return [("lowmem_batch", *(torch.from_numpy(x).to(dev) for x in (a, b)),
             chip_smoke.LOWMEM_K),
            ("pair_100kb", *(torch.from_numpy(x[None]).to(dev)
                             for x in (la, lb)), chip_smoke.LOWMEM_LONG_K)]


def meshes(parallel, dev) -> dict:
    """Case name -> mesh (None: unsharded)."""
    out = {"unsharded": None}
    for seq in (2, 4):
        out[f"seq{seq}_one_card"] = parallel.make_mesh(
            devices=[dev] * seq, data=1, seq=seq)
        if torch.cuda.device_count() >= seq:
            out[f"seq{seq}_cards"] = parallel.make_mesh(data=1, seq=seq)
    return out


def forward(wavefront, parallel, mesh, alpha, beta, sc, K):
    if mesh is None:
        return wavefront.lowmem_forward(alpha, beta, sc, GO, GE, K)[0]
    return parallel.shard_seq_forward(mesh, alpha, beta, sc, GO, GE, K)[0]


def timed(fn):
    """fn() and its time on the first card's clock, every card idle at
    the start and at the end."""
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    return out, start.elapsed_time(end)


def overlap(fn) -> dict:
    """One traced call of fn: the strips' kernel time summed, the span in
    which any of them ran (the union of their intervals, all cards), and
    the ratio, the mean number running at once."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel"
                   and "affine_fwd_block_kernel" in e.get("name", ""))
    busy, union, end = 0.0, 0.0, None
    for lo, hi in spans:
        busy += hi - lo
        if end is None or lo > end:
            union += hi - lo
            end = hi
        elif hi > end:
            union += hi - end
            end = hi
    return {"strip_kernels": len(spans), "kernel_ms": busy / 1e3,
            "span_ms": union / 1e3,
            "strips_at_once": busy / union if union else None}


def main() -> int:
    p = _timing.parser(__doc__, ("forward",))
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args()
    opened = _timing.open_card(p, args, "seq_timing")
    if opened is None:
        return 1
    wavefront, dev, smi, _ = opened
    from gonomics_tpu_torch import parallel
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    cases = meshes(parallel, dev)
    print(json.dumps({"cards": torch.cuda.device_count(),
                      "cases": list(cases)}), flush=True)
    ok = True
    for name, alpha, beta, K in inputs(dev):
        # each case's first call, untimed, with the unsharded forward
        # still queued on the caller's stream when it starts
        equal = {}
        for case, mesh in cases.items():
            if mesh is not None:
                want = forward(wavefront, parallel, None, alpha, beta, sc, K)
                got = forward(wavefront, parallel, mesh, alpha, beta, sc, K)
                equal[case] = _timing.equal(got, want)
                ok &= equal[case]
        del want, got
        times = {case: [] for case in cases}
        order = list(cases)
        for r in range(args.repeats):
            for case in order[r % len(order):] + order[:r % len(order)]:
                _, ms = timed(lambda: forward(wavefront, parallel,
                                              cases[case], alpha, beta, sc,
                                              K))
                times[case].append(ms)
                print(json.dumps({"input": name, "case": case, "round": r,
                                  "forward_ms": ms}), flush=True)
        base = float(np.median(times["unsharded"]))
        for case, ts in times.items():
            line = {"input": name, "case": case, "K": K,
                    "pairs": alpha.shape[0], "n": alpha.shape[1],
                    "m": beta.shape[1], "median_ms": float(np.median(ts)),
                    "over_unsharded": float(np.median(ts)) / base,
                    "runs_ms": ts, "card": smi.splitlines()[0]}
            if cases[case] is not None:
                line["checkpoints_equal_unsharded"] = equal[case]
                line["trace"] = overlap(lambda: forward(
                    wavefront, parallel, cases[case], alpha, beta, sc, K))
            print(json.dumps(line), flush=True)
    print(json.dumps({"checkpoints_equal_unsharded": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
