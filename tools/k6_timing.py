#!/usr/bin/env python3
"""Where affine_fwd_block's time goes (the lowmem forward K6, one
thread-block cluster a pair), on one CUDA card.

    python3 tools/k6_timing.py

Times K6 on block 16 of bench.py's lowmem batch (16 pairs of 16,384 x
16,384, K = 1024, the block chip_smoke.py times) with CUDA events, median
of 7 samples, at the wrapper's own plan and at forced cluster sizes, for
one pair and for 16. Each case prints one JSON line: its time,
microseconds a diagonal, the clusters the card holds at once, and whether
the result equals the plain version. A last line fits microseconds a
diagonal against the lanes a block sweeps over the one-pair cases whose
state is in shared memory: the slope is the cost of a lane, the intercept
what a diagonal costs whatever its lanes (the cluster barrier, the edge
lane's load, the loop). Needs a CUDA card; builds into the git-ignored
gonomics_tpu_torch/_build/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO  # noqa: E402
from gonomics_tpu_torch.ops import wavefront  # noqa: E402

# (pairs, cluster size or None for the wrapper's plan)
CASES = [(16, None), (16, 8), (16, 7), (16, 6), (16, 5), (16, 4),
         (1, 8), (1, 7), (1, 6), (1, 5), (1, 4), (1, 3), (1, 2)]
GO, GE, K, BLOCK = -600, -150, chip_smoke.LOWMEM_K, 16


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_timing: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    alpha, beta = (torch.from_numpy(x).to(dev)
                   for x in chip_smoke.lowmem_pairs())
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    n, m = alpha.shape[1], beta.shape[1]
    d0 = BLOCK * K
    ck, _ = wavefront.lowmem_forward(alpha, beta, sc, GO, GE, K)
    state = ck[BLOCK].contiguous()
    want = wavefront.affine_fwd_block_reference(alpha, beta, state, d0,
                                                n + m, sc, GO, GE, K)
    fit = []
    for B, CL in CASES:
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
            "pairs": B, "cluster": CL, "lanes_per_block": lanes,
            "state_in_shared_memory": in_smem, "ms": ms,
            "us_per_diagonal": ms * 1e3 / K,
            "resident_clusters": wavefront._fwd_config(CL, n, dev)[0],
            "equal_to_plain": equal, "card": smi}), flush=True)
        if not equal:
            return 1
    x, y = np.array(fit).T
    slope, intercept = np.polyfit(x, y, 1)
    print(json.dumps({"fit": "us_per_diagonal = intercept + slope x lanes",
                      "pairs": 1, "points": len(fit),
                      "ns_per_lane": slope * 1e3,
                      "intercept_us": intercept, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
