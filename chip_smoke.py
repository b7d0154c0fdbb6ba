#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gonomics_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device:  the card's name and power limit (nvidia-smi); builds the CUDA
            kernels and the host library from the checkout's sources.
2. kernels: a full-size batch (4096 reads x 150 bp, 198 bp windows) through
            banded_align_fused, the main path's kernel (the DP kernel's
            fused mode: the DP, best cell, walk and packing in one
            launch), held against the plain banded_align_full on the card
            (exact equality) and timed eagerly (ms) and in a CUDA graph
            (graph_ms), with its plan (lanes a thread, warps a block,
            registers, spills, shared memory). The same for banded_dp (the
            trace mode) and banded_walk_pack at this shape, which the main
            path does not take, in this phase's line only.
3. end_to_end: ReadAligner on a 100 Mbp seeded genome with the sparse
            index (step 8): 4 pipelined batches of 4096 x 150 bp reads;
            checks the mapped and correctly placed fractions, that junk
            stays unmapped, and that the main path launched the kernel its
            plan names (banded_align_fused); then one batch of 64 reads of
            13,000 bp, whose traces do not fit a block's shared memory,
            through the same aligner: mapped, placed, and launching
            banded_dp and banded_walk_pack. Then (line long_read_kernels)
            those two kernels on that batch's own inputs, as the aligner
            gave them: held against their plain versions (the walk from the
            plain DP's trace and best cells), timed, with banded_dp's plan,
            the walk's longest walk (max_steps) and the tiles its kernel
            loads (rounds: the most a read, and in all), counted on the
            plain walk's path; their rows of the kernels line come from
            here. banded_dp's global-codes variant (codes read from
            device memory), forced on that batch, is held against the
            same plain DP and timed. Then one read of 120,000 bp, past
            the staged codes' reach, through the same aligner: mapped,
            placed, its plan the global-codes variant, one launch each of
            banded_dp and banded_walk_pack; (line huge_read) its device
            step on its own inputs held against the plain
            banded_align_full on the card (the plain version timed once)
            and timed.
4. cli:     `gsw align ... --engine tpu -t 4` of the port (the North
            star's command line) on a 10 Mbp genome, single and paired,
            byte-equal to the library path's SAM for the same reads; and
            with --mesh, byte-equal to the runs without it.
5. mesh:    ReadAligner(mesh=make_mesh(data=1)) on that genome: 3
            batches of 4096 x 150 bp reads through the mesh path
            (shard_local_align: local_wavefront over each read's whole
            150 x 198 grid, then gsw_walk_pack's local side), the wall
            split into seeding, device, wait and emit; mapped and placed
            fractions >= 0.99, junk unmapped; the same SAM on a mesh of
            two data slices on the one card; the first 256 reads equal
            the mesh path on device="cpu"; the lines equal to the banded
            path's, counted; K4 and the local walk launched once a batch
            (twice on two slices), no banded kernel.
6. mesh_kernels: local_wavefront (K4) on the mesh phase's first batch
            (4096 x 150 x 198, the warp design at 8 slots a lane) and the
            local walk on K4's own trace, each held against its plain
            version on the card (exact, whole tensors) and timed eagerly
            and in a CUDA graph, with K4's plan, each bound, and the
            walk's longest walk and tiles; the walk's row of the kernels
            line comes from here, and K4's figures join its row there.
7. pairwise_kernels: affine_wavefront and const_wavefront, trace mode at
            128 pairs and score mode at 256 pairs of 1024 x 1024 (the
            kernel trace_diag but for the affine score mode, which is
            affine_score_diag's), each held against its plain PyTorch
            version on the card (exact equality, whole tensors) and timed,
            with its plan (rows a lane, warps a pair, registers, spills)
            and the device memory a call allocates above its inputs;
            plus trace mode on 2 pairs of 20,000 x 300 for each.
8. pairwise: affine_gap_batch and const_gap_batch on 128 related ~1 kb
            pairs: every route consumes both sequences and replays to its
            score, the first 8 pairs equal device="cpu", score mode
            equals trace mode; pairs/s and the wall split into kernel,
            trace copy to the host, and host walk.
9. pairwise_cli: the port's globalAlignment and cigarToBed on the card,
            stdout, -faOut and beds byte-equal to --device cpu.
10. graph:   GraphAligner with the gsw defaults (-i 32 -w 32, humanChimpTwo,
            gap -600) on the variant graph of a 50 Mbp chromosome (a SNP
            every 1 kb, a 1-30 bp deletion or insertion every 10 kb): one
            warm-up batch, then 4 batches of 2048 x 150 bp reads sampled
            along graph paths, pipelined 2 deep; checks the mapped
            fraction, that each read's giraf path lies on the path it was
            sampled from, that junk gets no path, that the first 256 reads' giraf equals
            device="cpu", and that every graph kernel was launched.
11. graph_kernels: 2048 left and 2048 right jobs of the graph phase's
            warm-up waves through local_wavefront, gsw_right_wavefront and
            gsw_walk_pack, each held against its plain PyTorch version on
            the card (exact equality) and timed (the walks also in a
            CUDA graph, with their max_steps and rounds as in phase 2),
            with each DP's launch plan (graph_dp_plan: one warp a job)
            and two bounds, the contract's whole trace and each job's
            own cells; plus both
            DPs on 2 jobs of a 10,300-base window (the warp design) and on
            16 jobs of 600-base read parts (past its reach: the block
            design), each checked to take that plan, exact and timed.
12. graph_cli: the port's `gsw align` on a 1 Mbp .gg, giraf and SAM, single
            and paired, byte-equal to --device cpu.
13. lowmem_kernels: affine_fwd_block, affine_bwd_window and
            lowmem_walk_block at bench.py's lowmem shape (16 pairs of
            16,384 x 16,384, K = 1024), each once on the middle block from
            the checkpoint and walk state the main path gives it, held
            against its plain PyTorch version on the card (exact equality)
            and timed, with its bound itemised; the cluster plans of
            affine_fwd_block (blocks a pair, clusters the card holds at
            once, shared memory a block) and of affine_bwd_window (blocks
            a pair, lanes a thread, warps a block, clusters held at once,
            waves), each as the kernel's own launch has it; and all three
            on the middle block of the 100 kb pair of phase 14 (K = 4096:
            K6 a global scratch a block, K7 a window of 8,832 lanes, the
            walk over K7's trace), exact and timed.
14. lowmem:  affine_gap_lowmem_batch on that batch: cells/s, the wall split
            into forward, backward and host, peak device memory against
            the full trace's; every route consumes both sequences and
            replays to its score, every score equals K2's score mode, the
            first 2 pairs equal the full-trace path, 4 pairs of 2 kb at
            K = 256 equal device="cpu", and a related 100 kb pair through
            the pairwise API (K = 4096) replays and equals K2's score.
15. score_kernels: affine_stream (K8) at bench.py's P = 8 x B = 256
            random pairs of 1024 x 1024, and affine_score_diag through
            wavefront_align_blocked (K9's contract) on 256 related pairs
            padded to 1024 x 1024 at r_rows = 512 and through K2's score
            mode on the 256 pairs of phase 7, each held against its plain
            PyTorch version on the card (exact equality) and timed, with
            each plan (stream_launch_plan, score_diag_launch_plan: rows a
            lane, warps a pair and a block, blocks, registers, spills);
            plus P = 2 with m even and m > n, n = 1, n below one strip
            with odd m, m much wider than n, r_rows not dividing n,
            r_rows + 1 > 1024 lanes, and K2's score mode with fin_b below
            and past n_b + m_b, m < n, n = 0 and one pair of 20,000 rows.
16. score:  bench.py's stage_score_stream: its parity gate (K2, the
            stream, the blocked kernel) against the plain versions on the
            CPU; K2's score mode, the stream and the blocked kernel once
            each on the stream's 2048 pairs, where all three must give the
            same score for every pair, with each call's peak device
            memory and the plans of affine_score_diag; G cells/s of each
            at bench.py's sizes.

Then the kernels line (launch counts of banded_align_fused from phase 3's
main batches, of banded_dp and banded_walk_pack from its long reads, of
the local walk from phase 5 (and K4's there as mesh_launches), of
the wavefront kernels from phase 8 (affine_wavefront's and
const_wavefront's, and under "trace_diag_launches" the launches of
the one CUDA kernel, "kernel", both take there), of the graph kernels
from phase 10, of the lowmem kernels from phase 14, of the score kernels
from phase 16) and, last, one JSON object naming the device. Without a
CUDA card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, L, PAD = 4096, 150, 24
W = L + 2 * PAD
# the end-to-end phase's long-read batch: reads whose traces do not fit a
# block's shared memory (banded_plan), which take banded_dp and
# banded_walk_pack
LONG_READS, LONG_L = 64, 13_000
# and one read whose staged codes do not fit a block's shared memory at
# one warp: banded_dp's global-codes variant
HUGE_L = 120_000
# the mesh phase: the CLI's 10 Mbp genome, MESH_BATCHES batches of B reads
# of L bp; its first MESH_CPU_READS reads against the CPU
CLI_BP, MESH_BATCHES, MESH_CPU_READS = 10_000_000, 3, 256
GAP = -600
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
# int32 lanes: 132 SMs x 64 INT32 units x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations that banded_dp's function needs, not those of one
# implementation. Per valid band cell (i <= n, i + c <= m): substitution
# address and table load (2), diag = prev + sub (1), base = max(diag,
# up + gap) as one DPX add-max (1), the test j <= m (1), base := NEG//2
# where invalid (1), a = base - gap*c (1), a sequential max-prefix from the
# NEG//2 fill (1), h = max(pre + gap*c, 0) as one DPX add-max (1), h := 0
# where invalid (1), left = h[c-1] + gap (1), trace code (3 compares,
# 3 selects), best cell (DPX max with predicate, 1 select). An invalid
# cell's h (0) and trace code (3) are constants, so it needs only its store.
DP_OPS_PER_VALID_CELL = 19
# per row of a read: clip its code, its score-table row offset, and the
# row's bound m (or 0 past the read); per window base used: clip its code
DP_OPS_PER_ROW = 4
DP_OPS_PER_WINDOW_BASE = 2
# per walk step: trace address, load, stop test, i and c updates, pack
# shift and or (the band walk stays inside the trace, so it needs no clip)
WALK_OPS_PER_STEP = 7

# Pairwise global alignment (BASELINE.json config 2, bench.py:120-129 and
# :179-188): trace mode at 128 pairs, score mode at 256, 1024 x 1024.
PAIR_LEN, PAIR_B_TRACE, PAIR_B_SCORE = 1024, 128, 256
# the API and CLI phases: related pairs of about 1 kb
RELATED_LEN, RELATED_PAIRS = 1000, 128
# the pairwise kernels' long case: 2 pairs of 20,000 x 300
BIG_N, BIG_M = 20_000, 300
AFFINE_GAPS, CONST_GAP = (-600, -150), -430
# int32 operations that each wavefront function needs per cell (i, j) of
# a pair's own n_b x m_b grid, not those of one implementation. Score
# mode, int32 operations only (the substitution score is a table load at
# an offset the cell's row and column fix, not an int32 operation): H =
# max(M, I), which the cell below reads for its D and, one step later,
# for its M (1); M = sub + max(H, D) at (i-1, j-1), a max and an add (2);
# I = max(go+ge+max(M, D), ge+I) at (i, j-1), a max, an add and a DPX
# add-max (3); D = max(go+ge+H, ge+D) at (i-1, j), an add and a DPX
# add-max (2). (An earlier count, 10, took the table's address and load
# as 2 and did not share H between D and M.) Trace mode counts the
# substitution address and table load (2) and writes each state's
# predecessor: the three candidates of I and of D as values (3 adds
# each), their DPX max3 (1 each), and per state an argmax in tie order (2
# compares, 2 selects: 4 each, M too), then the code tM + 4 tI + 16 tD
# (2).
AFFINE_OPS_PER_CELL = {"score": 1 + 2 + 3 + 2,
                       "trace": 2 + (1 + 1 + 4) + 2 * (3 + 1 + 4) + 2}
# const score mode: diag = c(i-1, j-1) + sub (1), max(c(i, j-1),
# c(i-1, j)) and a DPX add-max with the gap against diag (2); trace mode:
# left and up as values (2), a DPX max3 (1) and the argmax (4)
CONST_OPS_PER_CELL = {"score": 2 + 1 + 2, "trace": 2 + 1 + 2 + 1 + 4}

# Graph read aligner: the gsw defaults (-i 32 -w 32, humanChimpTwo, gap
# -600) and the CLI's batch of 2048 reads of 150 bp, on the variant graph
# of a 50 Mbp chromosome (the size of human chr22); the CLI phase on 1 Mbp.
GRAPH_BP, GRAPH_BATCH, GRAPH_BATCHES, GRAPH_JOBS = 50_000_000, 2048, 4, 2048
GRAPH_CLI_BP = 1_000_000
# a wide genome window, above the block design's shared-memory limits
# (8,532 bases for K4, 10,239 for K5): 2 jobs of a 10,300-base window and
# a 32-base part
GRAPH_WIDE_N, GRAPH_WIDE_M, GRAPH_WIDE_C = 10_300, 32, 2
# read parts past the graph DPs' warp design (m + 1 > 512 slots): the
# block design, 16 jobs of an 800-base window and 600-base read parts
GRAPH_BLOCK_N, GRAPH_BLOCK_M, GRAPH_BLOCK_C = 800, 600, 16
# int32 operations the graph DPs need per cell (i, j) of a job's own
# n_b x m_b grid, not those of one implementation. LeftDynamicAln:
# substitution address and table load (2), diag = c(i-1, j-1) + sub (1),
# max(c(i, j-1), c(i-1, j)) and one DPX add-max-relu with the gap against
# diag, which also clamps at 0 (2); left and up as values for the trace
# (2), their argmax in tie order (2 compares, 2 selects: 4), code 3 where
# c == 0 (1), the lane's best value and its diagonal (a DPX max with
# predicate and a select: 2). RightDynamicAln: the same without the clamp
# and the code 3 (13); the cells of its padded rectangle outside the
# job's own grid need all but the best (11); its row 0 and column 0 are
# gap * d, one operation a cell.
BEST_OPS_PER_CELL = 2
LOCAL_OPS_PER_CELL = 2 + 1 + 2 + 2 + 4 + 1 + BEST_OPS_PER_CELL
RIGHT_OPS_PER_CELL = 2 + 1 + 2 + 2 + 4 + BEST_OPS_PER_CELL
# per walk step: trace address, load, stop test, i and j updates, pack
# shift and or; the right side's end is a first-max over the job's lanes
# (a compare and a select a lane)
GSW_WALK_OPS_PER_STEP = 7
GSW_ARGMAX_OPS_PER_LANE = 2

# The lowmem aligner at bench.py's own configuration (bench.py:220-231):
# 16 random pairs of 16,384 x 16,384, humanChimpTwo, -600/-150, K = 1024,
# seed 3 (after bench.py's two 300 bp parity pairs from the same stream).
LOWMEM_B, LOWMEM_LEN, LOWMEM_K, LOWMEM_SEED = 16, 16384, 1024, 3
# its other gates: 4 related pairs of 2 kb at K = 256 against the CPU, and
# one related pair of 100 kb through the pairwise API at its default K
LOWMEM_SMALL, LOWMEM_SMALL_K, LOWMEM_LONG = 2000, 256, 100_000
# the pairwise API's default K (align.affine_gap_lowmem), the 100 kb pair's
LOWMEM_LONG_K = 4096
# affine_fwd_block's time a block in its earlier design, one thread block
# a pair (this script, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6)
K6_EARLIER_MS = 9.3823

# Score-only affine alignment at bench.py's stage_score_stream
# (bench.py:87-150): its parity gate (B0 = 8 pairs of L0 = 96, the stream
# at P0 = 4, seed 5), K2's score mode on B = 256 random pairs of 1024 x
# 1024 (seeds 2, 3) and the stream on P = 8 x B = 256 pairs of that size
# (seeds 0, 1), HUMAN_CHIMP_TWO, -600/-150; the row-blocked kernel at the
# same B and size with its default r_rows = 512.
SCORE_B0, SCORE_L0, SCORE_P0 = 8, 96, 4
SCORE_B, SCORE_L, SCORE_P, SCORE_R = 256, 1024, 8, 512
# per walk step: trace address, load, activity test, the next state's
# shift and mask, i and j updates
LOWMEM_WALK_OPS_PER_STEP = 7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def once_ms(fn):
    """fn() and its time on the card's clock, one call (for plain
    versions too slow to repeat)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, runs: int = 25, inner: int = 1) -> float:
    """Median over `runs` samples of the card time per call of fn, each
    sample timed with CUDA events around `inner` back-to-back calls (so
    that the host's launch overhead hides behind a short kernel)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def graph_ms(fn, runs: int = 15, inner: int = 20) -> float:
    """Median over `runs` replays of a CUDA graph of `inner` calls of fn,
    per call: the card's time for back-to-back launches without the
    host's time a call (tens of microseconds of Python and ctypes), which
    a kernel shorter than it would otherwise wait for between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def dp_operations(n_vec: np.ndarray, m_vec: np.ndarray, length: int = L) -> int:
    """int32 operations banded_dp's function needs for reads of lengths
    n_vec (at most `length`) in windows of lengths m_vec (see
    DP_OPS_PER_VALID_CELL)."""
    rows = np.minimum(n_vec.astype(np.int64), length)
    i = np.arange(1, length + 1)
    lanes = np.clip(m_vec[:, None].astype(np.int64) - i + 1, 0, 64)
    valid = int(np.where(i <= rows[:, None], lanes, 0).sum())
    bases = int(np.clip(np.minimum(m_vec, rows + 63), 0, None).sum())
    return (DP_OPS_PER_VALID_CELL * valid + DP_OPS_PER_ROW * int(rows.sum())
            + DP_OPS_PER_WINDOW_BASE * bases)


def phase_device() -> dict:
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    # build the host library and the kernels side by side
    t0 = time.perf_counter()
    host = threading.Thread(target=native.available)
    host.start()
    _kernels.build_all()
    host.join()
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "build_s": time.perf_counter() - t0,
            "native_host_library": native.available(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def kernel_batch(seed: int, n: int = B, length: int = L):
    """n anchored (read, window) pairs of reads of `length` in windows of
    length + 2 PAD: SNPs, 5 bp deletions and insertions, short reads,
    lowercase bases and junk rows."""
    rng = np.random.default_rng(seed)
    width = length + 2 * PAD
    wins = rng.integers(0, 4, (n, width)).astype(np.int8)
    wins[rng.random((n, width)) < 0.001] = 4
    reads = wins[:, PAD:PAD + length].copy()
    n_vec = np.full(n, length, np.int32)
    for b in range(n):
        kind = b % 10
        if kind == 1:      # 5 bp deletion from the read
            reads[b, 75:] = wins[b, PAD + 80:PAD + 80 + length - 75]
        elif kind == 2:    # 5 bp insertion into the read
            reads[b, 80:] = reads[b, 75:length - 5].copy()
            reads[b, 75:80] = rng.integers(0, 4, 5)
        elif kind == 3:    # short read
            n_vec[b] = int(rng.integers(100, length))
            reads[b, n_vec[b]:] = 4
        elif kind == 4:    # lowercase bases
            reads[b, rng.integers(0, length, 12)] += 5
        elif kind == 5:    # junk
            reads[b] = rng.integers(0, 4, length)
        snp = rng.integers(0, length, 1 + b % 3)
        reads[b, snp] = (reads[b, snp] % 5 + 1) % 4
    return reads, wins, n_vec, np.full(n, width, np.int32)


def equal_err(got, want):
    """Whether two tuples of tensors are equal, and their largest absolute
    difference."""
    torch.cuda.synchronize()
    return (all(torch.equal(g, w) for g, w in zip(got, want)),
            max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got, want)))


BANDED_DP_REPLACES = ("gonomics_tpu/ops/wavefront.py:709 (_banded_kernel, "
                      "pallas_call :850)")
BANDED_WALK_REPLACES = ("gonomics_tpu/ops/wavefront.py:789 (_banded_walk) + "
                        ":874-883 (packing)")


def banded_row(name: str, equal: bool, err: int, bound: dict, replaces: str,
               timing: tuple, **extra) -> dict:
    """One kernel's row of the kernels line (launches filled in later):
    timing is (ms, graph_ms, plain_ms); bound the bytes and operations
    times, the larger of which is bound_ms."""
    by = max(bound, key=bound.get)
    ms, gms, plain = timing
    return {"name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/banded.cu",
            "replaces": replaces, "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err, "ms": ms, "graph_ms": gms,
            "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
            "library_ms": None, **extra}


def dp_and_walk_rows(dp_args: tuple, length: int, plain_once: bool):
    """banded_dp and banded_walk_pack on one batch, dp_args = (reads,
    windows, n_vec, m_vec, scores, gap) on the card: each held against
    its plain version (the walk from the plain DP's trace and best cells)
    and timed eagerly (ms) and in a CUDA graph (graph_ms), with bounds
    from this batch's inputs, banded_dp's plan and the walk's longest
    walk (max_steps) and the tiles its kernel loads (rounds: the most a
    read, and in all), counted on the plain walk's path. The plain
    versions are timed once where plain_once (long reads), else as the
    kernels are. Returns (rows, the plain DP's result, the walk's steps
    and ops bytes a read)."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = dp_args[:4]
    n, width = wins.shape
    plain_dp = (lambda: banded.banded_dp_reference(*dp_args))
    if plain_once:
        want, dp_plain_ms = once_ms(plain_dp)
    else:
        want, dp_plain_ms = plain_dp(), median_ms(plain_dp)
    dp_equal, dp_err = equal_err(banded.banded_dp(*dp_args), want)

    bv, bi, trace = want
    score, i_star, c_star = banded.best_cell(bv, bi)
    walk_args = (trace, i_star, c_star, score > 0,
                 banded.walk_length(length))
    plain_walk = (lambda: banded.banded_walk_pack_reference(*walk_args))
    if plain_once:
        wwant, walk_plain_ms = once_ms(plain_walk)
    else:
        wwant, walk_plain_ms = plain_walk(), median_ms(plain_walk)
    walk_equal, walk_err = equal_err(banded.banded_walk_pack(*walk_args),
                                     wwant)

    # bounds from this batch: bytes each input read once and each output
    # written once, and the operations this batch's cells need over the
    # int32 rate
    in_bytes = n * length + n * width + 8 * n + 100
    dp_bytes = in_bytes + 2 * n * 64 * 4 + length * n * 64
    dp_ops = dp_operations(n_vec.cpu().numpy(), m_vec.cpu().numpy(), length)
    dp_bound = {"bytes": dp_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": dp_ops / INT32_OPS_PER_S * 1e3}
    # the cells the walk reads (one a move, plus the one it stops on) and
    # the tiles its kernel enters, from the plain walk's path
    w_steps, w_rounds = banded.walk_rounds(*walk_args)
    steps = int(w_steps.sum())
    P = wwant[2].shape[1]
    walk_bytes = n * (4 + 4 + 1) + n * (4 + 4 + P) + steps
    walk_bound = {"bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": WALK_OPS_PER_STEP * steps / INT32_OPS_PER_S * 1e3}

    def dp():
        return banded.banded_dp(*dp_args)

    def walk():
        return banded.banded_walk_pack(*walk_args)

    # eager (`ms`) and in a CUDA graph (`graph_ms`): launched eagerly, a
    # call may wait on the host's time a call
    rows = [banded_row("banded_dp", dp_equal, dp_err, dp_bound,
                       BANDED_DP_REPLACES,
                       (median_ms(dp, inner=20), graph_ms(dp), dp_plain_ms),
                       plan=banded.banded_launch_plan(n, length, "dp"),
                       dp_operations=dp_ops),
            banded_row("banded_walk_pack", walk_equal, walk_err, walk_bound,
                       BANDED_WALK_REPLACES,
                       (median_ms(walk, inner=20), graph_ms(walk),
                        walk_plain_ms),
                       max_steps=int(w_steps.max()),
                       rounds=int(w_rounds.max()),
                       rounds_total=int(w_rounds.sum()), walk_steps=steps)]
    return rows, want, (steps, P)


ROW_KEYS = ("name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "graph_ms", "plan", "dp_operations",
            "max_steps", "rounds", "rounds_total", "walk_steps")


def phase_kernels(dev: torch.device) -> list[dict]:
    """The main path's kernel, banded_align_fused, on the main batch;
    banded_dp and banded_walk_pack at the same shape too, in this phase's
    line only (the main path does not take them: their rows come from
    the long reads, phase_long_read_kernels)."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(dev)
                                 for x in kernel_batch(1))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    dp_args = (reads, wins, n_vec, m_vec, sc, GAP)
    off_path, _, (steps, P) = dp_and_walk_rows(dp_args, L, plain_once=False)
    fwant = banded.banded_align_full_reference(*dp_args)
    fused_equal, fused_err = equal_err(banded.banded_align_fused(*dp_args),
                                       fwant)
    # the fused mode: the DP's and the walk's operations; its bytes are
    # the inputs and the six outputs (no trace leaves the chip)
    dp_ops = off_path[0]["dp_operations"]
    fused_bytes = B * L + B * W + 8 * B + 100 + B * (5 * 4 + P)
    fused_bound = {"bytes": fused_bytes / HBM_BYTES_PER_S * 1e3,
                   "operations": (dp_ops + WALK_OPS_PER_STEP * steps)
                   / INT32_OPS_PER_S * 1e3}

    def fused():
        return banded.banded_align_fused(*dp_args)

    row = banded_row(
        "banded_align_fused", fused_equal, fused_err, fused_bound,
        BANDED_DP_REPLACES + " + :789 (_banded_walk) + :874-883 (packing) "
        "in banded_align_full :815",
        (median_ms(fused, inner=20), graph_ms(fused),
         median_ms(lambda: banded.banded_align_full_reference(*dp_args),
                   runs=5)),
        plan=banded.banded_launch_plan(B, L, "fused"))
    emit({"phase": "kernels", "shape": {"B": B, "L": L, "W": W},
          "kernels": [{k: r[k] for k in ROW_KEYS if k in r} for r in [row]],
          "trace_mode_at_this_shape": [{k: r[k] for k in ROW_KEYS if k in r}
                                       for r in off_path]})
    if not (fused_equal and all(r["equal_to_plain"] for r in off_path)):
        raise SystemExit("a kernel disagrees with its plain version")
    return [row]


def phase_long_read_kernels(dev: torch.device, batch: tuple) -> list[dict]:
    """banded_dp and banded_walk_pack on the inputs the end-to-end phase's
    long-read batch gave them (batch: its reads, windows, n_vec and m_vec
    as the aligner made them, and the aligner's scores and gap), the path
    that takes them: each held against its plain version, timed, with its
    bound and plan from these inputs."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    n, length = reads.shape
    dp_args = (reads, wins, n_vec, m_vec, scores.to(torch.int32),
               int(batch[5]))
    rows, want, _ = dp_and_walk_rows(dp_args, length, plain_once=True)
    # banded_dp's global-codes variant (the plan of reads past the staged
    # codes' reach), forced on these inputs, against the same plain DP
    plan = banded.banded_launch_plan(n, length, "dp", codes="global")

    def dp_global():
        return banded._banded_launch(plan, *dp_args)

    g_equal, g_err = equal_err(dp_global(), want)
    global_codes = {"plan": plan, "equal_to_plain": g_equal,
                    "max_abs_err": g_err,
                    "ms": median_ms(dp_global, runs=5, inner=3),
                    "graph_ms": graph_ms(dp_global, runs=5, inner=3)}
    emit({"phase": "long_read_kernels",
          "shape": {"B": n, "L": length, "W": wins.shape[1]},
          "kernels": [{k: r[k] for k in ROW_KEYS if k in r} for r in rows],
          "banded_dp_global_codes_at_this_shape": global_codes})
    if not (g_equal and all(r["equal_to_plain"] for r in rows)):
        raise SystemExit("a kernel disagrees with its plain version")
    rows[0]["global_codes"] = {k: global_codes[k] for k in (
        "equal_to_plain", "ms", "graph_ms")}
    return rows


def phase_huge_read(dev: torch.device, batch: tuple) -> dict:
    """The device step of the end-to-end phase's HUGE_L bp read, on its
    own inputs (batch as phase_long_read_kernels takes it): the plan
    banded_plan gives it (the trace mode's global-codes variant), the
    step through banded_align_full held against
    banded_align_full_reference on the card (exact; the plain version
    timed once) and timed, banded_dp and banded_walk_pack each timed."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    n, length = reads.shape
    args = (reads, wins, n_vec, m_vec, scores.to(torch.int32), int(batch[5]))
    plan = banded.banded_launch_plan(n, length)
    want, plain_ms = once_ms(lambda: banded.banded_align_full_reference(
        *args))
    equal, err = equal_err(banded.banded_align_full(*args), want)
    bv, bi, trace = banded.banded_dp(*args)
    score, i_star, c_star = banded.best_cell(bv, bi)
    walk_args = (trace, i_star, c_star, score > 0,
                 banded.walk_length(length))
    out = {"phase": "huge_read", "shape": {"B": n, "L": length,
                                           "W": wins.shape[1]},
           "plan": plan, "equal_to_plain": equal, "max_abs_err": err,
           "tolerance": "exact", "score": int(want[0][0]),
           "ms": median_ms(lambda: banded.banded_align_full(*args), runs=5),
           "plain_ms": plain_ms,
           "banded_dp_ms": median_ms(lambda: banded.banded_dp(*args),
                                     runs=5),
           "banded_walk_pack_ms": median_ms(
               lambda: banded.banded_walk_pack(*walk_args), runs=5)}
    emit(out)
    if not (equal and plan["codes"] == "global"):
        raise SystemExit("the huge read's device step disagrees with its "
                         "plain version")
    return out


def make_reads(genome: np.ndarray, n: int, seed: int, prefix: str = "r",
               L: int = L):
    """n reads of L bp with one SNP each, every other one reverse-
    complemented; every 64th a 5 bp deletion, every 64th (offset 32) a
    5 bp insertion, every 100th junk. Returns (reads, truth) with truth
    the start (or -1 for junk)."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.fastq import Fastq

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - L - 10, n)
    reads, truth = [], []
    qual = np.full(L, 30, np.uint8)
    for i, s in enumerate(starts):
        s = int(s)
        seq = genome[s:s + L].copy()
        if i % 64 == 1:
            seq = np.concatenate([genome[s:s + 75], genome[s + 80:s + L + 5]])
        elif i % 64 == 33:
            seq = np.concatenate([genome[s:s + 75],
                                  rng.integers(0, 4, 5).astype(np.int8),
                                  genome[s + 75:s + L - 5]])
        p = int(rng.integers(0, L))
        seq[p] = (seq[p] + 1) % 4
        if i % 100 == 7:
            seq = rng.integers(0, 4, L).astype(np.int8)
            s = -1
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(Fastq(f"{prefix}{i}", seq, qual))
        truth.append(s)
    return reads, np.array(truth)


def check_sam(text: str, truth: np.ndarray) -> dict:
    lines = text.splitlines()
    assert len(lines) == len(truth), (len(lines), len(truth))
    mapped = placed = junk_mapped = 0
    for line, s in zip(lines, truth):
        f = line.split("\t")
        flag, pos, cigar = int(f[1]), int(f[3]), f[5]
        if s < 0:
            junk_mapped += not flag & 4
            continue
        if flag & 4:
            continue
        mapped += 1
        m = re.match(r"(\d+)S", cigar)
        placed += pos - 1 - (int(m.group(1)) if m else 0) == s
    real = int((truth >= 0).sum())
    return {"mapped_frac": mapped / real, "placed_frac": placed / real,
            "junk": len(truth) - real, "junk_mapped": junk_mapped}


def phase_end_to_end(dev: torch.device, G: int) -> tuple[dict, tuple,
                                                          tuple]:
    """ReadAligner end to end on the main batches, then on one batch of
    long reads and on one read of HUGE_L bp; returns the phase's line and
    the long batch's and the huge read's inputs to the device step, each
    with the aligner's scores and gap (phase_long_read_kernels,
    phase_huge_read)."""
    from gonomics_tpu_torch import dna, native
    from gonomics_tpu_torch.io.fasta import Fasta
    from gonomics_tpu_torch.ops import banded
    from gonomics_tpu_torch.read_align import ReadAligner

    # the reads/s and host split below are those of the native host path
    if not native.available():
        raise SystemExit("the native host library did not build")
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, G, dtype=np.int8)
    t0 = time.perf_counter()
    al = ReadAligner([Fasta("chr1", genome)], index_mode="sparse",
                     index_step=8, device=dev)
    build_s = time.perf_counter() - t0

    # span on the card's clock of each batch's device step, from the first
    # upload to the result in host memory (host enqueue gaps included)
    spans = []
    device_result = al._device_result
    last_inputs = []  # the last batch's (read_seqs, windows, n_vec, m_vec)

    def timed_device_result(*args):
        last_inputs[:] = [args]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = device_result(*args)
        end.record()
        spans.append((start, end))
        return res

    al._device_result = timed_device_result
    batches = [make_reads(genome, B, 100 + t) for t in range(4)]
    al.finish_batch_lines(al.align_batch_async(batches[0][0]))  # warm-up

    # host seed+vote alone, on the same batches
    seed_ms = []
    for reads, _ in batches:
        fwd = np.stack([r.seq for r in reads])
        rev = dna.complement(fwd[:, ::-1]).astype(np.int8)
        t1 = time.perf_counter()
        al._candidates(fwd, rev)
        seed_ms.append((time.perf_counter() - t1) * 1e3)

    # the main path: launch counts from this loop only
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    spans.clear()
    texts, dispatch_ms, finish_ms = [], [], []

    def finish(handle) -> None:
        t1 = time.perf_counter()
        texts.append(al.finish_batch_lines(handle))
        finish_ms.append((time.perf_counter() - t1) * 1e3)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for reads, _ in batches:
        t1 = time.perf_counter()
        handle = al.align_batch_async(reads)
        dispatch_ms.append((time.perf_counter() - t1) * 1e3)
        if pending is not None:
            finish(pending)
        pending = handle
    finish(pending)
    wall = time.perf_counter() - t0
    device_ms = [s.elapsed_time(e) for s, e in spans]
    launches = {"banded_align_fused": banded.fused_launches,
                "banded_dp": banded.dp_launches,
                "banded_walk_pack": banded.walk_launches}
    # the kernel banded_plan gives the main path's batches
    main_kernel = ("banded_align_fused"
                   if banded.banded_launch_plan(B, L)["mode"] == "fused"
                   else "banded_dp")

    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))
    # the long-read path: reads whose traces do not fit a block's shared
    # memory take banded_dp and banded_walk_pack; launch counts from this
    # batch only
    long_reads, long_truth = make_reads(genome, LONG_READS, 200, "long",
                                        LONG_L)
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    t1 = time.perf_counter()
    long_text = al.finish_batch_lines(al.align_batch_async(long_reads))
    long_path = {"reads": LONG_READS, "read_len": LONG_L,
                 "plan": banded.banded_launch_plan(LONG_READS, LONG_L)["mode"],
                 "wall_ms": (time.perf_counter() - t1) * 1e3,
                 "launches": {"banded_align_fused": banded.fused_launches,
                              "banded_dp": banded.dp_launches,
                              "banded_walk_pack": banded.walk_launches},
                 **check_sam(long_text, long_truth)}
    long_inputs = last_inputs[0]
    # one read past the staged codes' reach (fault 3.3 before): the trace
    # mode's global-codes variant and the walk
    huge_reads, huge_truth = make_reads(genome, 1, 201, "huge", HUGE_L)
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    t1 = time.perf_counter()
    huge_text = al.finish_batch_lines(al.align_batch_async(huge_reads))
    huge_plan = banded.banded_launch_plan(1, HUGE_L)
    huge_path = {"reads": 1, "read_len": HUGE_L,
                 "plan": {k: huge_plan[k] for k in (
                     "mode", "codes", "lanes_per_thread", "warps_per_block",
                     "smem_bytes", "registers", "spill_bytes")},
                 "wall_ms": (time.perf_counter() - t1) * 1e3,
                 "launches": {"banded_align_fused": banded.fused_launches,
                              "banded_dp": banded.dp_launches,
                              "banded_walk_pack": banded.walk_launches},
                 **check_sam(huge_text, huge_truth)}
    out = {"phase": "end_to_end", "genome_bp": G, "index": "sparse step 8",
           "batches": len(batches), "batch": B, "read_len": L,
           "index_build_s": build_s, "reads_per_s": len(batches) * B / wall,
           "wall_ms_per_batch": wall * 1e3 / len(batches),
           # span on the card's clock from the first upload to the result
           # in host memory, over wall time; the span includes the host's
           # enqueue gaps, so it bounds the card's busy share from above
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "host_seed_vote_ms_per_batch": float(np.mean(seed_ms)),
           "host_dispatch_ms_per_batch": float(np.mean(dispatch_ms)),
           "host_finish_ms_per_batch": float(np.mean(finish_ms)),
           "device_ms_per_batch": float(np.mean(device_ms)),
           "native_host_library": native.available(),
           "main_kernel": main_kernel, "launches": launches, **checks,
           "long_reads": long_path, "huge_read": huge_path}
    emit(out)
    long_launches = long_path["launches"]
    huge_launches = huge_path["launches"]
    if not (checks["mapped_frac"] >= 0.99 and checks["placed_frac"] >= 0.99
            and checks["junk_mapped"] == 0
            and main_kernel == "banded_align_fused"
            and launches["banded_align_fused"] > 0
            and long_path["plan"] == "dp"
            and long_launches["banded_dp"] > 0
            and long_launches["banded_walk_pack"] > 0
            and long_launches["banded_align_fused"] == 0
            and long_path["mapped_frac"] >= 0.99
            and long_path["placed_frac"] >= 0.99
            and long_path["junk_mapped"] == 0
            and huge_path["plan"]["codes"] == "global"
            and huge_launches["banded_dp"] == 1
            and huge_launches["banded_walk_pack"] == 1
            and huge_path["mapped_frac"] == 1.0
            and huge_path["placed_frac"] == 1.0):
        raise SystemExit("end-to-end check failed")
    # each kernel's launches from the path that takes it
    out["launches"] = {"banded_align_fused": launches["banded_align_fused"],
                       "banded_dp": long_launches["banded_dp"],
                       "banded_walk_pack": long_launches["banded_walk_pack"]}
    return (out, (*long_inputs, al.scores, al.gap),
            (*last_inputs[0], al.scores, al.gap))


def cli_genome(G: int) -> np.ndarray:
    """The CLI and mesh phases' genome of G bases, from seed 2."""
    return np.random.default_rng(2).integers(0, 4, G, dtype=np.int8)


def phase_cli(dev: torch.device, G: int) -> dict:
    """`gsw align --engine tpu` single and paired, byte-equal to the
    library path; then with --mesh, byte-equal to the runs without it."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fasta, fastq
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = cli_genome(G)
    single, _ = make_reads(genome, 3000, 7)
    r1, _ = make_reads(genome, 1000, 8, prefix="p")
    r2, _ = make_reads(genome, 1000, 9, prefix="p")
    result = {"phase": "cli", "genome_bp": len(genome)}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        s = dna.to_string(genome)
        with open(ref, "w") as f:
            f.write(">chrS\n")
            f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
        paths = {}
        for name, reads in (("single", single), ("r1", r1), ("r2", r2)):
            paths[name] = os.path.join(tmp, name + ".fq")
            with open(paths[name], "w") as f:
                for r in reads:
                    f.write(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                            f"{fastq.qual_string(r.qual)}\n")
        # the North star's command line: gsw align ref.fa reads.fq
        # --engine tpu, with -t as the JAX CLI takes it
        flags = ["--engine", "tpu", "-t", "4", "--device", dev.type]
        result["flags"] = " ".join(flags)
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, paths["single"], "-o",
                      os.path.join(tmp, "single.sam"), *flags])
        gsw_cmd.main(["align", ref, paths["r1"], paths["r2"], "-o",
                      os.path.join(tmp, "paired.sam"), *flags])
        result["cli_s"] = time.perf_counter() - t0

        al = ReadAligner(fasta.read(ref), device=dev)
        head = "".join(line + "\n" for line in al.header().text)
        reads = fastq.read(paths["single"])
        want_single = head + "".join(
            al.finish_batch_lines(al.align_batch_async(reads[i:i + 2048]))
            for i in range(0, len(reads), 2048))
        pairs = list(zip(fastq.read(paths["r1"]), fastq.read(paths["r2"])))
        want_paired = head + "".join(
            s.to_string() + "\n" for i in range(0, len(pairs), 2048)
            for s in al.align_pairs(pairs[i:i + 2048]))
        for name, want in (("single", want_single), ("paired", want_paired)):
            with open(os.path.join(tmp, name + ".sam")) as f:
                got = f.read()
            result[f"{name}_equal"] = got == want
            result[f"{name}_lines"] = got.count("\n")
        # --mesh: every CUDA device of the process, the mesh path
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, paths["single"], "-o",
                      os.path.join(tmp, "single_mesh.sam"), *flags,
                      "--mesh"])
        gsw_cmd.main(["align", ref, paths["r1"], paths["r2"], "-o",
                      os.path.join(tmp, "paired_mesh.sam"), *flags,
                      "--mesh"])
        result["mesh_cli_s"] = time.perf_counter() - t0
        for name in ("single", "paired"):
            with open(os.path.join(tmp, name + ".sam"), "rb") as f:
                plain = f.read()
            with open(os.path.join(tmp, name + "_mesh.sam"), "rb") as f:
                result[f"{name}_mesh_equal"] = f.read() == plain
    emit(result)
    if not (result["single_equal"] and result["paired_equal"]):
        raise SystemExit("CLI SAM differs from the library path")
    if not (result["single_mesh_equal"] and result["paired_mesh_equal"]):
        raise SystemExit("gsw align --mesh differs from the run without it")
    return result


def phase_mesh(dev: torch.device, G: int) -> dict:
    """ReadAligner's mesh path (ReadAligner(mesh=), each batch through
    shard_local_align: local_wavefront over every read's whole (L, W)
    grid and the local walk) on the CLI phase's genome: MESH_BATCHES
    batches of B reads of L bp on make_mesh(data=1), one after another,
    with the wall split into seeding (host), device (the card's span from
    the upload to the result in host memory), the wait for it and emit
    (SAM text); the same batches on a mesh of two data slices on the one
    card (the device repeated), which must give the same SAM; the first
    MESH_CPU_READS reads against the mesh path on the CPU; the lines equal
    to the banded path's, counted (a full local DP and a 64-lane band may
    end differently on ties). Returns the phase's line, with the first
    batch's inputs to the device step for phase_mesh_kernels."""
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.io.fasta import Fasta
    from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = cli_genome(G)
    t0 = time.perf_counter()
    base = ReadAligner([Fasta("chrS", genome)], device=dev)
    build_s = time.perf_counter() - t0
    state = base.state()
    al = ReadAligner.from_state(state, device=dev, mesh=make_mesh(data=1))
    al2 = ReadAligner.from_state(
        state, device=dev, mesh=make_mesh(devices=["cuda:0"] * 2, data=2))
    batches = [make_reads(genome, B, 300 + t) for t in range(MESH_BATCHES)]

    spans, seeding, inputs = [], [], []
    device_result, candidates = al._device_result, al._candidates

    def timed_device_result(*args):
        inputs.append(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = device_result(*args)
        end.record()
        spans.append((start, end))
        return res

    def timed_candidates(*args):
        t1 = time.perf_counter()
        out = candidates(*args)
        seeding.append((time.perf_counter() - t1) * 1e3)
        return out

    al._device_result, al._candidates = timed_device_result, timed_candidates
    al.finish_batch_lines(al.align_batch_async(batches[0][0]))  # warm-up
    al2.finish_batch_lines(al2.align_batch_async(batches[0][0]))
    spans.clear()
    seeding.clear()
    inputs.clear()

    # the main path: launch counts from this loop only
    wavefront.local_launches = gsw_dp.local_walk_launches = 0
    banded.fused_launches = banded.dp_launches = banded.walk_launches = 0
    texts, dispatch_ms, wait_ms, emit_ms = [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for reads, _ in batches:
        t1 = time.perf_counter()
        handle = al.align_batch_async(reads)
        t2 = time.perf_counter()
        handle[5].numpy()  # the device result in host memory
        t3 = time.perf_counter()
        texts.append(al.finish_batch_lines(handle))
        t4 = time.perf_counter()
        dispatch_ms.append((t2 - t1) * 1e3)
        wait_ms.append((t3 - t2) * 1e3)
        emit_ms.append((t4 - t3) * 1e3)
    wall = time.perf_counter() - t0
    launches = {"local_wavefront": wavefront.local_launches,
                "local_walk_pack": gsw_dp.local_walk_launches,
                "banded_kernels": banded.fused_launches + banded.dp_launches
                + banded.walk_launches}
    device_ms = [s.elapsed_time(e) for s, e in spans]
    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))

    # two data slices on the one card
    wavefront.local_launches = gsw_dp.local_walk_launches = 0
    texts2 = [al2.finish_batch_lines(al2.align_batch_async(reads))
              for reads, _ in batches]
    launches2 = {"local_wavefront": wavefront.local_launches,
                 "local_walk_pack": gsw_dp.local_walk_launches}
    # the mesh path on the CPU, the first reads
    cpu = ReadAligner.from_state(state, device="cpu",
                                 mesh=make_mesh(devices=["cpu"], data=1))
    head = batches[0][0][:MESH_CPU_READS]
    cpu_text = cpu.finish_batch_lines(cpu.align_batch_async(head))
    card_head = "".join(texts[0].splitlines(True)[:MESH_CPU_READS])
    # the banded path on the same batches
    lines = "".join(texts).splitlines()
    banded_lines = "".join(
        base.finish_batch_lines(base.align_batch_async(reads))
        for reads, _ in batches).splitlines()
    same = sum(a == b for a, b in zip(lines, banded_lines))
    n_reads = MESH_BATCHES * B
    out = {"phase": "mesh", "genome_bp": G, "batches": MESH_BATCHES,
           "batch": B, "read_len": L, "window": W, "walk_steps": L + W,
           "index_build_s": build_s, "reads_per_s": n_reads / wall,
           "wall_ms_per_batch": wall * 1e3 / MESH_BATCHES,
           "host_seed_vote_ms_per_batch": float(np.mean(seeding)),
           "host_dispatch_ms_per_batch": float(np.mean(dispatch_ms)),
           "device_ms_per_batch": float(np.mean(device_ms)),
           "wait_ms_per_batch": float(np.mean(wait_ms)),
           "host_emit_ms_per_batch": float(np.mean(emit_ms)),
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "native_host_library": native.available(),
           "launches": launches, **checks,
           "data2_same_sam": texts2 == texts, "data2_launches": launches2,
           "cpu_reads": MESH_CPU_READS, "cpu_equal": cpu_text == card_head,
           "banded_equal_lines": same, "banded_equal_frac": same / n_reads}
    emit(out)
    if not (checks["mapped_frac"] >= 0.99 and checks["placed_frac"] >= 0.99
            and checks["junk_mapped"] == 0 and out["data2_same_sam"]
            and out["cpu_equal"] and len(lines) == n_reads
            and launches["local_wavefront"] == MESH_BATCHES
            and launches["local_walk_pack"] == MESH_BATCHES
            and launches["banded_kernels"] == 0
            and launches2["local_wavefront"] == 2 * MESH_BATCHES
            and launches2["local_walk_pack"] == 2 * MESH_BATCHES):
        raise SystemExit("mesh check failed")
    out["inputs"] = (*inputs[0], al.scores, al.gap)
    return out


MESH_WALK_REPLACES = ("gonomics_tpu/ops/wavefront.py:661-696 "
                      "(local_align_full's best cell, lax.scan walk and "
                      "packing: jnp glue after K4)")


def phase_mesh_kernels(dev: torch.device, batch: tuple) -> tuple[dict, dict]:
    """local_wavefront (K4) at the mesh path's shape, on the inputs the
    mesh phase's first batch gave it, and the local walk on K4's own
    trace: each held against its plain version on the card (exact, whole
    tensors) and timed eagerly (ms) and in a CUDA graph (graph_ms), with
    K4's plan, each bound from these inputs (K4: its inputs, bv and bd,
    and the whole trace, or its job's own cells' operations; the walk: the
    cells its steps read, the bests its first-max reads, the rows it
    writes, or those steps' and lanes' operations) and the walk's longest
    walk and tiles. Returns the walk's row of the kernels line and K4's
    figures at this shape."""
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    alpha, beta, nv, mv, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    args = (alpha, beta, nv, mv, scores.to(torch.int32), int(batch[5]))
    C, n = alpha.shape
    m = beta.shape[1]
    S = n + 1

    def k4():
        return wavefront.local_wavefront(*args)

    want, k4_plain_ms = once_ms(lambda: wavefront.local_wavefront_reference(
        *args))
    k4_equal, k4_err = equal_err(k4(), want)
    bv, bd, trace = want
    walk_args = ("local", trace, bv, bd)

    def walk():
        return gsw_dp.gsw_walk_pack(*walk_args)

    wwant, walk_plain_ms = once_ms(lambda: gsw_dp.gsw_walk_pack_reference(
        *walk_args))
    walk_equal, walk_err = equal_err((walk(),), (wwant,))
    steps, rounds = gsw_dp.walk_rounds(*walk_args)
    n_steps = int(steps.sum())

    k4_bound = graph_dp_bound("local", nv.cpu().numpy(), mv.cpu().numpy(),
                              n, m, corner=False)
    walk_bytes = C * (4 * S + 4) + n_steps + wwant.numel()
    walk_bound = {"bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": (GSW_WALK_OPS_PER_STEP * n_steps
                                 + GSW_ARGMAX_OPS_PER_LANE * C * S)
                  / INT32_OPS_PER_S * 1e3}
    k4_by = max(("bytes", "operations"), key=k4_bound.get)
    walk_by = max(walk_bound, key=walk_bound.get)
    k4_row = {"shape": {"B": C, "n": n, "m": m},
              "plan": wavefront.graph_dp_plan(C, n, m, "local"),
              "equal_to_plain": k4_equal, "max_abs_err": k4_err,
              "ms": median_ms(k4, runs=15, inner=5),
              "graph_ms": graph_ms(k4, runs=10, inner=5),
              "plain_ms": k4_plain_ms, "bound_ms": k4_bound[k4_by],
              "bound_by": k4_by, "trace_bytes": C * (n + m) * S,
              "cells": k4_bound["cells"],
              "bound_job_cells_ms": k4_bound["bound_job_cells_ms"]}
    walk_row = {"name": "local_walk_pack", "route": "cuda",
                "source": "gonomics_tpu_torch/csrc/gsw_dp.cu",
                "replaces": MESH_WALK_REPLACES, "launches": None,
                "equal_to_plain": walk_equal, "tolerance": "exact",
                "max_abs_err": walk_err,
                "ms": median_ms(walk, runs=15, inner=20),
                "graph_ms": graph_ms(walk), "plain_ms": walk_plain_ms,
                "bound_ms": walk_bound[walk_by], "bound_by": walk_by,
                "library_ms": None,
                "shape": f"{C} reads of {n} bp in {m} bp windows",
                "max_steps": int(steps.max()), "rounds": int(rounds.max()),
                "rounds_total": int(rounds.sum()), "walk_steps": n_steps}
    emit({"phase": "mesh_kernels", "tolerance": "exact",
          "local_wavefront": k4_row,
          "local_walk_pack": {k: v for k, v in walk_row.items()
                              if k not in ("route", "source", "launches",
                                           "library_ms")}})
    if not (k4_equal and walk_equal and k4_row["plan"]["design"] == "warp"):
        raise SystemExit("a mesh kernel disagrees with its plain version or "
                         "did not take its plan")
    return walk_row, k4_row


def related_pair(rng, L: int, same_length: bool):
    """A random sequence of L bases and a relative of it: 2% SNPs, 0.5%
    N, a deletion and an insertion of 1-30 bp each (of the same length
    when same_length, so that the pair stays L x L)."""
    a = rng.integers(0, 4, L).astype(np.int8)
    b = a.copy()
    b[rng.random(L) < 0.02] = rng.integers(0, 4)
    b[rng.random(L) < 0.005] = 4
    k_del = int(rng.integers(1, 31))
    k_ins = k_del if same_length else int(rng.integers(1, 31))
    cut = int(rng.integers(0, L - k_del))
    b = np.concatenate([b[:cut], b[cut + k_del:]])
    at = int(rng.integers(0, len(b)))
    b = np.concatenate([b[:at], rng.integers(0, 4, k_ins).astype(np.int8),
                        b[at:]])
    return a, b


def pair_batch(B: int, n: int, m: int, seed: int, dev):
    """B related pairs padded to (n, m) as tensors on dev: alpha, beta,
    fin = n_b + m_b, and each pair's (n_b, m_b). Pair b has a prefix of
    length n - b % 7 of one related n-bp pair against m - b % 5 bases of
    its relative (cut or padded with random bases)."""
    rng = np.random.default_rng(seed)
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    dims = []
    for b in range(B):
        a, r = related_pair(rng, n, same_length=True)
        nb, mb = n - b % 7, m - b % 5
        r = np.concatenate([r, rng.integers(0, 4, max(0, mb - len(r)))])[:mb]
        alpha[b, :nb] = a[:nb]
        beta[b, :mb] = r
        dims.append((nb, mb))
    dims = np.array(dims)
    fin = dims.sum(1).astype(np.int32)
    return (torch.from_numpy(alpha).to(dev), torch.from_numpy(beta).to(dev),
            torch.from_numpy(fin).to(dev), dims)


def wavefront_bound(mode: str, kind: str, dims: np.ndarray, n: int, m: int,
                    results: int | None = None, cells: int | None = None
                    ) -> dict:
    """Least time for one wavefront call: each input read once and each
    output written once (in trace mode the whole (n+m, B, n+1) trace, and
    `results` int32 values, by default the (B, n+1) rows of K2/K3) at the
    memory rate, and the operations that `cells` (by default each pair's
    own n_b x m_b) need at the int32 rate."""
    B = len(dims)
    if cells is None:
        cells = int((dims[:, 0].astype(np.int64) * dims[:, 1]).sum())
    if results is None:
        results = (3 if (mode, kind) == ("affine", "trace") else 1) * B * (n + 1)
    nbytes = B * (n + m) + 4 * B + 100 + 4 * results
    if kind == "trace":
        nbytes += (n + m) * B * (n + 1)
    per_cell = (AFFINE_OPS_PER_CELL if mode == "affine"
                else CONST_OPS_PER_CELL)[kind]
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": per_cell * cells / INT32_OPS_PER_S * 1e3,
            "cells": cells}


def diagonal_cells(rows: int, m: int, fin) -> int:
    """The cells (i, j), 1 <= i <= rows and 1 <= j <= m, on or before each
    pair's diagonal fin_b, summed over the pairs: what affine_score_diag's
    function needs to read out diagonal fin_b of a grid of rows x m."""
    i = np.arange(1, rows + 1, dtype=np.int64)
    f = np.asarray(fin, np.int64).reshape(-1, 1)
    return int(np.clip(f - i, 0, m).sum())


def phase_pairwise_kernels(dev: torch.device) -> list[dict]:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    gaps = {"affine": AFFINE_GAPS, "const": (CONST_GAP, 0)}

    def kernel(mode, a, b, f, with_trace):
        go, ge = gaps[mode]
        return wavefront.wavefront_align(a, b, f, sc, gap_open=go,
                                         gap_extend=ge, with_trace=with_trace,
                                         mode=mode)

    def plain(mode, a, b, f, with_trace):
        if mode == "affine":
            return wavefront.affine_wavefront_reference(
                a, b, f, sc, *AFFINE_GAPS, with_trace)
        return wavefront.const_wavefront_reference(a, b, f, sc, CONST_GAP,
                                                   with_trace)

    def compare(mode, args, with_trace):
        got = kernel(mode, *args, with_trace)
        want = plain(mode, *args, with_trace)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    def plan_of(mode, kind, B, n, m):
        """trace_diag's launch plan (K2's score mode is
        affine_score_diag's)."""
        if (mode, kind) == ("affine", "score"):
            return wavefront.score_diag_launch_plan(B, n, m)
        return wavefront.trace_diag_launch_plan(
            B, n, m, mode if kind == "trace" else "const_score")

    cases, ok = [], True
    for mode in ("affine", "const"):
        for kind, B in (("trace", PAIR_B_TRACE), ("score", PAIR_B_SCORE)):
            a, b, f, dims = pair_batch(B, PAIR_LEN, PAIR_LEN,
                                       seed=B + len(mode), dev=dev)
            tr = kind == "trace"
            equal, err = compare(mode, (a, b, f), tr)
            # device memory the call allocates above its inputs, at its peak
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            out = kernel(mode, a, b, f, tr)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - before
            del out
            # trace mode: the whole padded grid; score mode: the cells on
            # or before each pair's diagonal fin_b, where the kernel stops
            cells = (B * PAIR_LEN * PAIR_LEN if tr else diagonal_cells(
                PAIR_LEN, PAIR_LEN, f.cpu().numpy()))
            bound = wavefront_bound(mode, kind, dims, PAIR_LEN, PAIR_LEN,
                                    cells=cells)
            by = "bytes" if bound["bytes"] > bound["operations"] else \
                "operations"
            cases.append({
                "mode": mode, "kind": kind, "B": B, "n": PAIR_LEN,
                "m": PAIR_LEN,
                "plan": plan_of(mode, kind, B, PAIR_LEN, PAIR_LEN),
                "equal_to_plain": equal, "max_abs_err": err,
                "ms": median_ms(lambda: kernel(mode, a, b, f, tr), runs=15,
                                inner=5),
                "plain_ms": median_ms(lambda: plain(mode, a, b, f, tr),
                                      runs=3),
                "bound_ms": bound[by], "bound_by": by,
                "cells": bound["cells"], "peak_above_inputs_bytes": peak})
            ok &= equal
        # 2 pairs of 20,000 rows against a small m: 157 strips a pair at
        # R = 4, over the most warps a pair
        a, b, f, _ = pair_batch(2, BIG_N, BIG_M, seed=3, dev=dev)
        equal, err = compare(mode, (a, b, f), True)
        cases.append({"mode": mode, "kind": "trace", "B": 2, "n": BIG_N,
                      "m": BIG_M, "plan": plan_of(mode, "trace", 2, BIG_N,
                                                  BIG_M),
                      "equal_to_plain": equal, "max_abs_err": err})
        ok &= equal
    emit({"phase": "pairwise_kernels", "tolerance": "exact", "cases": cases})
    if not ok:
        raise SystemExit("a wavefront kernel disagrees with its plain version")
    rows = []
    plan_keys = ("rows_per_lane", "warps_per_pair", "registers",
                 "spill_bytes")
    for mode, name in (("affine", "affine_wavefront"),
                       ("const", "const_wavefront")):
        trace_case, score_case, _ = [c for c in cases if c["mode"] == mode]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/wavefront.cu",
            "kernel": "trace_diag",
            "replaces": (f"gonomics_tpu/ops/wavefront.py:"
                         f"{94 if mode == 'affine' else 243} "
                         f"(_{mode}_kernel, pallas_call :1584)"),
            "launches": None, "tolerance": "exact",
            "equal_to_plain": all(c["equal_to_plain"] for c in cases
                                  if c["mode"] == mode),
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["mode"] == mode),
            "ms": trace_case["ms"], "plain_ms": trace_case["plain_ms"],
            "bound_ms": trace_case["bound_ms"],
            "bound_by": trace_case["bound_by"], "library_ms": None,
            "shape": f"trace mode, {trace_case['B']} pairs of "
                     f"{PAIR_LEN} x {PAIR_LEN}",
            "plan": {k: trace_case["plan"][k] for k in plan_keys}})
        if mode == "const":  # the affine score mode is affine_score_diag's
            rows[-1]["score_mode"] = {
                **{k: score_case[k] for k in (
                    "B", "ms", "plain_ms", "bound_ms", "bound_by")},
                "plan": {k: score_case["plan"][k] for k in plan_keys}}
    return rows


def replay_score(a, b, route, scores, gap_open: int, gap_extend: int) -> int:
    """Score of a route, replayed from the cigar alone: scores[a, b] per
    match column, and gap_open + gap_extend * length per gap run (a
    linear gap g is gap_open 0, gap_extend g)."""
    from gonomics_tpu_torch.align.cigar import COL_I, COL_M

    total = i = j = 0
    for c in route:
        if c.op == COL_M:
            total += int(scores[a[i:i + c.run_length],
                                b[j:j + c.run_length]].sum())
            i += c.run_length
            j += c.run_length
        else:
            total += gap_open + gap_extend * c.run_length
            if c.op == COL_I:
                j += c.run_length
            else:
                i += c.run_length
    return total


def consumed(route) -> tuple[int, int]:
    from gonomics_tpu_torch.align.cigar import COL_D, COL_I

    return (sum(c.run_length for c in route if c.op != COL_I),
            sum(c.run_length for c in route if c.op != COL_D))


def phase_pairwise(dev: torch.device) -> dict:
    from gonomics_tpu_torch import align
    from gonomics_tpu_torch.align import pairwise
    from gonomics_tpu_torch.ops import wavefront

    H = align.HUMAN_CHIMP_TWO
    rng = np.random.default_rng(17)
    pairs = [related_pair(rng, RELATED_LEN, same_length=False)
             for _ in range(RELATED_PAIRS)]
    calls = {"affine": lambda p, **kw: align.affine_gap_batch(
                 p, H, *AFFINE_GAPS, **kw),
             "const": lambda p, **kw: align.const_gap_batch(
                 p, H, CONST_GAP, **kw)}
    gaps = {"affine": AFFINE_GAPS, "const": (0, CONST_GAP)}
    calls["affine"](pairs[:2], device=dev)  # warm-up
    calls["const"](pairs[:2], device=dev)

    # split of the wall: the kernel (card clock, synchronised here so
    # that the copy after it is timed alone), the copies to the host and
    # the host walks
    split = {}
    wrapped = {}

    def timed(name, fn, device_side=False):
        def run(*args, **kw):
            if device_side:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                end.synchronize()
                split[name] = split.get(name, 0.0) + start.elapsed_time(end)
                return out
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            split[name] = (split.get(name, 0.0)
                           + (time.perf_counter() - t0) * 1e3)
            return out
        return run

    for attr, name, dev_side in (("wavefront_align", "kernel_ms", True),
                                 ("_to_host", "copy_ms", False),
                                 ("_walk_affine", "walk_ms", False),
                                 ("_walk_const", "walk_ms", False)):
        wrapped[attr] = getattr(pairwise, attr)
        setattr(pairwise, attr, timed(name, wrapped[attr], dev_side))

    # the main path: launch counts from these calls only
    wavefront.affine_launches = wavefront.const_launches = 0
    wavefront.trace_diag_launches = 0
    out = {"phase": "pairwise", "pairs": len(pairs),
           "lengths": [int(min(len(a) for a, _ in pairs)),
                       int(max(max(len(a), len(b)) for a, b in pairs))]}
    results = {}
    try:
        for mode in ("affine", "const"):
            split.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[mode] = calls[mode](pairs, device=dev)
            wall = (time.perf_counter() - t0) * 1e3
            out[mode] = {"wall_ms": wall,
                         "pairs_per_s": len(pairs) / wall * 1e3,
                         **split,
                         "other_ms": wall - sum(split.values())}
    finally:
        for attr, fn in wrapped.items():
            setattr(pairwise, attr, fn)
    launches = {"affine_wavefront": wavefront.affine_launches,
                "const_wavefront": wavefront.const_launches,
                "trace_diag": wavefront.trace_diag_launches}
    out["launches"] = launches

    ok = all(v > 0 for v in launches.values())
    for mode in ("affine", "const"):
        got = results[mode]
        consumes = all(consumed(r) == (len(a), len(b))
                       for (a, b), (_, r) in zip(pairs, got))
        replays = all(replay_score(a, b, r, H, *gaps[mode]) == s
                      for (a, b), (s, r) in zip(pairs, got))
        cpu = calls[mode](pairs[:8], device="cpu")
        same_as_cpu = [(s, [(c.run_length, c.op) for c in r])
                       for s, r in got[:8]] == \
            [(s, [(c.run_length, c.op) for c in r]) for s, r in cpu]
        scores_only = calls[mode](pairs, device=dev, with_cigar=False)
        score_mode = [s for s, _ in scores_only] == [s for s, _ in got]
        out[mode].update({"routes_consume_both": consumes,
                          "routes_replay_to_score": replays,
                          "first_8_equal_cpu": same_as_cpu,
                          "score_mode_equal": score_mode})
        ok &= consumes and replays and same_as_cpu and score_mode
    emit(out)
    if not ok:
        raise SystemExit("pairwise check failed")
    return out


def phase_pairwise_cli() -> dict:
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import cigar_to_bed, global_alignment

    rng = np.random.default_rng(23)
    a, b = related_pair(rng, RELATED_LEN, same_length=False)
    inputs = {"chelsea_eric": ("TTGTTATTC", "TTGTTC"),
              "related_1kb": (dna.to_string(a), dna.to_string(b))}
    result = {"phase": "pairwise_cli"}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for case, (s_a, s_b) in inputs.items():
            fa = []
            for name, seq in (("chelsea", s_a), ("eric", s_b)):
                path = os.path.join(tmp, f"{case}.{name}.fa")
                with open(path, "w") as f:
                    f.write(f">{name}\n")
                    f.writelines(seq[i:i + 60] + "\n"
                                 for i in range(0, len(seq), 60))
                fa.append(path)
            outputs = {}
            for device in ("cuda", "cpu"):
                pre = os.path.join(tmp, f"{case}.{device}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    global_alignment.main([*fa, "-faOut", pre + ".ga.fa",
                                           "--device", device])
                    cigar_to_bed.main([*fa, "-faOut", pre + ".c2b.fa",
                                       "-insBedOut", pre + ".ins.bed",
                                       "-delBedOut", pre + ".del.bed",
                                       "--device", device])
                files = []
                for ext in (".ga.fa", ".c2b.fa", ".ins.bed", ".del.bed"):
                    with open(pre + ext, "rb") as f:
                        files.append(f.read())
                outputs[device] = [buf.getvalue().encode(), *files]
            equal = outputs["cuda"] == outputs["cpu"]
            lines = outputs["cuda"][0].decode().split("\n")
            result[case] = {"card_equals_cpu": equal,
                            "stdout_bytes": len(outputs["cuda"][0]),
                            "ins_bed_lines": outputs["cuda"][3].count(b"\n")}
            ok &= equal
            if case == "chelsea_eric":
                view_ok = lines[1:3] == ["TTGTTATTC", "TTG---TTC"]
                result[case]["view"] = lines[1:3]
                ok &= view_ok
    emit(result)
    if not ok:
        raise SystemExit("pairwise CLI output differs")
    return result


def graph_vcfs(genome: np.ndarray, seed: int) -> list:
    """Variants of a chromosome: a SNP every 1 kb and, at 5 kb past every
    10 kb, a deletion (odd tens of kb) or an insertion (even) of 1-30
    bp."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.vcf import Vcf

    rng = np.random.default_rng(seed)
    out = []
    for p in range(1000, len(genome) - 1000, 1000):
        base = genome[p - 1:p]
        if p % 10000 == 5000:
            k = int(rng.integers(1, 31))
            if (p // 10000) % 2:
                out.append(Vcf("chr1", p, ".",
                               dna.to_string(genome[p - 1:p + k]),
                               [dna.to_string(base)], "SVTYPE=DEL"))
            else:
                ins = rng.integers(0, 4, k).astype(np.int8)
                out.append(Vcf("chr1", p, ".", dna.to_string(base),
                               [dna.to_string(np.concatenate([base, ins]))],
                               "SVTYPE=INS"))
        else:
            alt = (base + int(rng.integers(1, 4))) % 4
            out.append(Vcf("chr1", p, ".", dna.to_string(base),
                           [dna.to_string(alt.astype(np.int8))],
                           "SVTYPE=SNP"))
    return out


def build_graph(G: int, seed: int):
    from gonomics_tpu_torch import graph as port_graph
    from gonomics_tpu_torch.io.fasta import Fasta

    genome = np.random.default_rng(seed).integers(0, 4, G, dtype=np.int8)
    return port_graph.variant_graph([Fasta("chr1", genome)],
                                    {"chr1": graph_vcfs(genome, seed + 1)})


def graph_reads(g, n: int, seed: int, prefix: str):
    """n reads of L bp along random paths of g (start uniform over the
    graph's bases, a random successor at every node end, so alt alleles
    and indel branches are taken), one substitution each, every other
    one reverse-complemented, every 100th random junk. Returns the reads
    (FastqBig) and each one's sampled path: the nodes its bases came from,
    in order (empty for junk)."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.fastq import FastqBig

    rng = np.random.default_rng(seed)
    lens = np.array([len(nd.seq) for nd in g.nodes], np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    qual = np.full(L, 30, np.uint8)
    reads, truth = [], []
    while len(reads) < n:
        i = len(reads)
        if i % 100 == 7:
            seq, path = rng.integers(0, 4, L).astype(np.int8), []
        else:
            r = int(rng.integers(0, cum[-1]))
            start = int(np.searchsorted(cum, r, side="right")) - 1
            cur = g.nodes[start]
            parts = [cur.seq[r - cum[start]:]]
            path = [start]
            got = len(parts[0])
            while got < L and cur.next:
                cur = g.nodes[cur.next[int(rng.integers(0, len(cur.next)))].dest]
                parts.append(cur.seq)
                path.append(cur.id)
                got += len(cur.seq)
            if got < L:
                continue
            seq = np.concatenate(parts)[:L].astype(np.int8)
            p = int(rng.integers(0, L))
            seq[p] = (seq[p] + int(rng.integers(1, 4))) % 4
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(FastqBig(f"{prefix}{i}", seq,
                              dna.reverse_complement(seq).astype(np.int8),
                              qual))
        truth.append(path)
    return reads, truth


def check_girafs(girafs, truth: list) -> dict:
    """Mapped: a path and a score of at least 1200 (the SAM projection's
    threshold). A giraf path lists the nodes of the read's winning seed
    only (the reference's toGiraf), not those its extensions reach, so a
    read that starts a few bases before a node boundary can have its path
    start at the next node: placed counts the reads whose path nodes all
    lie on their sampled path, and the start node's presence is reported
    beside it."""
    mapped = placed = has_start = junk_pathed = 0
    for gr, path in zip(girafs, truth):
        if not path:
            junk_pathed += bool(gr.path.nodes)
            continue
        if gr.path.nodes and gr.aln_score >= 1200:
            mapped += 1
            placed += set(gr.path.nodes) <= set(path)
            has_start += path[0] in gr.path.nodes
    real = sum(bool(p) for p in truth)
    return {"mapped_frac": mapped / real, "path_on_sampled_path_frac":
            placed / real, "start_node_in_path_frac": has_start / real,
            "junk": len(truth) - real, "junk_with_path": junk_pathed}


def phase_graph(dev: torch.device) -> tuple[dict, list]:
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.graph_align import GraphAligner
    from gonomics_tpu_torch.io import giraf
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    # the reads/s and host split below are those of the native seed path
    if not native.available():
        raise SystemExit("the native host library did not build")
    t0 = time.perf_counter()
    g = build_graph(GRAPH_BP, 5)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    al = GraphAligner(g, device=dev)
    index_s = time.perf_counter() - t0
    batches = [graph_reads(g, GRAPH_BATCH, 200 + t, "g")
               for t in range(1 + GRAPH_BATCHES)]

    # each wave's jobs and its span on the card's clock, from the first
    # upload to the result copy enqueued to the host; host seeding time
    jobs, spans, seed_ms = [], [], []
    start_wave, find_seeds = al.dp.start_wave, al._find_seeds_arrays

    def timed_start_wave(*args):
        jobs.append(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wave = start_wave(*args)
        end.record()
        spans.append((start, end))
        return wave

    def timed_find_seeds(reads):
        t1 = time.perf_counter()
        out = find_seeds(reads)
        seed_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    al.dp.start_wave, al._find_seeds_arrays = timed_start_wave, \
        timed_find_seeds
    al.finish_batch(al.align_batch_async(batches[0][0]))  # warm-up
    warm_jobs = list(jobs)

    # the main path: launch counts from this loop only
    wavefront.local_launches = wavefront.gsw_right_launches = 0
    gsw_dp.walk_launches = 0
    jobs.clear()
    spans.clear()
    seed_ms.clear()
    finish_ms, results = [], []

    def finish(handle):
        t1 = time.perf_counter()
        out = al.finish_batch(handle)
        finish_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque()
        for reads, _ in batches[1:]:
            futs.append(ex.submit(finish, al.align_batch_async(reads)))
            while len(futs) > 1:
                results.extend(futs.popleft().result())
        while futs:
            results.extend(futs.popleft().result())
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in spans]
    launches = {"local_wavefront": wavefront.local_launches,
                "gsw_right_wavefront": wavefront.gsw_right_launches,
                "gsw_walk_pack": gsw_dp.walk_launches}
    del al.dp.start_wave, al._find_seeds_arrays

    checks = check_girafs(results, [p for _, t in batches[1:] for p in t])
    # the first 256 reads again, with the DPs' plain versions on the CPU
    cpu = copy.copy(al)
    cpu.dp = gsw_dp.GswDpBatch(al.host.scores, -600, device="cpu")
    first = batches[1][0][:256]
    same_as_cpu = ([giraf.to_string(x) for x in results[:256]]
                   == [giraf.to_string(x) for x in cpu.align_batch(first)])
    n_reads = GRAPH_BATCHES * GRAPH_BATCH
    out = {"phase": "graph", "genome_bp": GRAPH_BP, "nodes": len(g.nodes),
           "edges": sum(len(nd.next) for nd in g.nodes),
           "seed_len": al.host.seed_len, "step": al.host.step_size,
           "batches": GRAPH_BATCHES, "batch": GRAPH_BATCH, "read_len": L,
           "graph_build_s": graph_s, "index_build_s": index_s,
           "reads_per_s": n_reads / wall,
           "wall_ms_per_batch": wall * 1e3 / GRAPH_BATCHES,
           "host_seed_ms_per_batch": float(np.mean(seed_ms)),
           "waves": len(device_ms),
           "jobs_left": int(sum(len(j[0]) for j in jobs)),
           "jobs_right": int(sum(len(j[4]) for j in jobs)),
           "device_span_ms_per_batch": sum(device_ms) / GRAPH_BATCHES,
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "host_finish_ms_per_batch": float(np.mean(finish_ms)),
           "dims": {"left": list(al.dp._dims["left"]),
                    "right": list(al.dp._dims["right"])},
           "native_host_library": native.available(),
           "first_256_equal_cpu": same_as_cpu, "launches": launches,
           **checks}
    emit(out)
    if not (checks["mapped_frac"] >= 0.99
            and checks["path_on_sampled_path_frac"] >= 0.99
            and checks["junk_with_path"] == 0 and same_as_cpu
            and all(v > 0 for v in launches.values())):
        raise SystemExit("graph check failed")
    return out, warm_jobs


def stack_jobs(waves: list, side: int, count: int, dims: list):
    """The first `count` jobs of one side (0 left, 4 right) over the
    recorded waves, padded with code 4 to the widest wave or to the main
    path's final sticky dims, whichever is wider."""
    n = max([dims[0]] + [w[side].shape[1] for w in waves])
    m = max([dims[1]] + [w[side + 1].shape[1] for w in waves])
    al, be = [], []
    for w in waves:
        a, b = w[side], w[side + 1]
        al.append(np.pad(a, ((0, 0), (0, n - a.shape[1])), constant_values=4))
        be.append(np.pad(b, ((0, 0), (0, m - b.shape[1])), constant_values=4))
    nv = np.concatenate([np.asarray(w[side + 2], np.int32) for w in waves])
    mv = np.concatenate([np.asarray(w[side + 3], np.int32) for w in waves])
    return (np.concatenate(al)[:count], np.concatenate(be)[:count],
            nv[:count], mv[:count])


def graph_dp_bound(kind: str, nv: np.ndarray, mv: np.ndarray, n: int,
                   m: int, corner: bool = True) -> dict:
    """Least time of one graph DP call. bytes: the inputs read once and
    the outputs written once, the trace whole as the contract has it (C
    (n+m) S bytes, most of them its constant), at the memory rate;
    operations: the cells whose values the contract needs at the int32
    rate (K4 each job's own n_b x m_b cells; K5 its padded rectangle, n x m
    interior cells and n + m edge cells a job, since the trace there is
    part of the contract, with the row's best updated on the job's own
    cells only). The job-cells figure (the trace as each job's own cells,
    the operations of those cells) is what a DP fused with its walk could
    reach."""
    C = len(nv)
    cells = int((nv.astype(np.int64) * mv).sum())
    rows = 3 if kind == "local" and corner else 2   # bv, bd (and corner)
    inputs = C * (n + m) + 8 * C + 100 + rows * 4 * C * (n + 1)
    nbytes = inputs + C * (n + m) * (n + 1)
    job_ops = (LOCAL_OPS_PER_CELL * cells if kind == "local" else
               RIGHT_OPS_PER_CELL * cells + int((nv + mv).sum()))
    ops = (job_ops if kind == "local" else
           C * ((RIGHT_OPS_PER_CELL - BEST_OPS_PER_CELL) * n * m + n + m)
           + BEST_OPS_PER_CELL * cells)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": t_bytes, "operations": t_ops, "cells": cells,
            "bound_job_cells_ms": max((inputs + cells) / HBM_BYTES_PER_S,
                                      job_ops / INT32_OPS_PER_S) * 1e3}


def walk_bound(left_rows, right_rows, steps: int, S_r: int) -> dict:
    """Least time of one wave's two walk-packs: the trace cells the walks
    read (`steps`: one a move, plus the cell a left walk stops on), the
    values they need (one corner a left job, all bv lanes and one bd a
    right job), the rows written; the operations of those steps and of
    the right side's first-max."""
    C_l, C_r = len(left_rows), len(right_rows)
    nbytes = (C_l * (4 + 8) + C_r * (4 * S_r + 4) + steps
              + left_rows.size + right_rows.size)
    ops = (GSW_WALK_OPS_PER_STEP * steps
           + GSW_ARGMAX_OPS_PER_LANE * C_r * S_r)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": ops / INT32_OPS_PER_S * 1e3, "steps": steps}


def wide_window_jobs(left: bool, dev):
    """GRAPH_WIDE_C jobs of a GRAPH_WIDE_N-base window: read parts copied
    from the window's end (left jobs) or start (right jobs) with a SNP,
    the second job shorter on both sides."""
    n, m, C = GRAPH_WIDE_N, GRAPH_WIDE_M, GRAPH_WIDE_C
    rng = np.random.default_rng(41)
    al = rng.integers(0, 4, (C, n)).astype(np.int8)
    be = np.ascontiguousarray(al[:, -m:] if left else al[:, :m])
    be[:, m // 2] = (be[:, m // 2] + 1) % 4
    nv = np.array([n, n - 700], np.int32)
    mv = np.array([m, m - 2], np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (al, be, nv, mv))


def block_design_jobs(left: bool, dev):
    """GRAPH_BLOCK_C jobs of a GRAPH_BLOCK_N-base window and read parts of
    GRAPH_BLOCK_M bases, past the warp design's reach: read parts copied
    from the window's end (left jobs) or start (right jobs) with a SNP
    every 50 bases, every other job shorter on both sides."""
    n, m, C = GRAPH_BLOCK_N, GRAPH_BLOCK_M, GRAPH_BLOCK_C
    rng = np.random.default_rng(43)
    al = rng.integers(0, 4, (C, n)).astype(np.int8)
    be = np.ascontiguousarray(al[:, -m:] if left else al[:, :m])
    be[:, 25::50] = (be[:, 25::50] + 1) % 4
    nv = np.where(np.arange(C) % 2, n - 100, n).astype(np.int32)
    mv = np.where(np.arange(C) % 2, m - 40, m).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (al, be, nv, mv))


def phase_graph_kernels(dev: torch.device, waves: list,
                        dims: dict) -> list[dict]:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    sides = {}
    for name, side in (("left", 0), ("right", 4)):
        al, be, nv, mv = stack_jobs(waves, side, GRAPH_JOBS, dims[name])
        sides[name] = (nv, mv, al.shape[1], be.shape[1],
                       tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                             for x in (al, be, nv, mv)))

    def equal_err(got, want):
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    nv_l, mv_l, n_l, m_l, left = sides["left"]
    nv_r, mv_r, n_r, m_r, right = sides["right"]
    local = lambda: wavefront.local_wavefront(*left, sc, GAP, True)  # noqa: E731
    local_plain = lambda: wavefront.local_wavefront_reference(  # noqa: E731
        *left, sc, GAP, True)
    rdp = lambda: wavefront.gsw_right_wavefront(*right, sc, GAP)  # noqa: E731
    rdp_plain = lambda: wavefront.gsw_right_wavefront_reference(  # noqa: E731
        *right, sc, GAP)
    lres, rres = local_plain(), rdp_plain()
    _, _, ltrace, corner = lres
    bv, bd, rtrace = rres

    def walks(fn):
        return (fn("left", ltrace, corner, None, left[2], left[3]),
                fn("right", rtrace, bv, bd))

    wplain = walks(gsw_dp.gsw_walk_pack_reference)
    # the cells the walks read and the tiles the kernel loads, from the
    # plain walks' paths
    paths = [gsw_dp.walk_rounds("left", ltrace, corner, None, left[2],
                                left[3]),
             gsw_dp.walk_rounds("right", rtrace, bv, bd)]
    walk_steps = int(sum(st.sum() for st, _ in paths))
    walk_path = {"max_steps": max(int(st.max()) for st, _ in paths),
                 "rounds": max(int(rd.max()) for _, rd in paths),
                 "rounds_total": int(sum(rd.sum() for _, rd in paths)),
                 "max_steps_by_side": [int(st.max()) for st, _ in paths],
                 "rounds_by_side": [int(rd.max()) for _, rd in paths]}
    cases = {
        "local_wavefront": (local, local_plain,
                            graph_dp_bound("local", nv_l, mv_l, n_l, m_l)),
        "gsw_right_wavefront": (rdp, rdp_plain,
                                graph_dp_bound("right", nv_r, mv_r, n_r,
                                               m_r)),
        "gsw_walk_pack": (lambda: walks(gsw_dp.gsw_walk_pack),
                          lambda: walks(gsw_dp.gsw_walk_pack_reference),
                          walk_bound(wplain[0].cpu().numpy(),
                                     wplain[1].cpu().numpy(), walk_steps,
                                     n_r + 1)),
    }
    replaces = {
        "local_wavefront": "gonomics_tpu/ops/wavefront.py:179 (_local_kernel,"
                           " pallas_call :451 in wavefront_local :415)",
        "gsw_right_wavefront": "gonomics_tpu/ops/wavefront.py:289 "
                               "(_gsw_right_kernel, pallas_call :368 in "
                               "wavefront_gsw_right :348)",
        "gsw_walk_pack": "gonomics_tpu/ops/gsw_dp.py:30-157 (_walk_left, "
                         "_walk_right, _left_full, _right_full, "
                         "_pack_result: jnp glue)"}
    # K4 and K5 on the main path's jobs at their plans, then on 2 jobs of
    # a 10,300-base window (the warp design, the trace filled first) and
    # on jobs whose read part is past the warp design's reach (the block
    # design, a barrier a diagonal), each with the plan it should take
    plans = {"local_wavefront": wavefront.graph_dp_plan(len(nv_l), n_l, m_l,
                                                        "local"),
             "gsw_right_wavefront": wavefront.graph_dp_plan(
                 len(nv_r), n_r, m_r, "gsw_right")}
    ok = all(p["design"] == "warp" for p in plans.values())
    extra = {"wide_window": {}, "block_design": {}}
    # the job-cells bounds go to this phase's line only: the kernels line
    # keeps bound_ms as each kernel's one bound
    job_cells = {}
    for case, make, design in (("wide_window", wide_window_jobs, "warp"),
                               ("block_design", block_design_jobs,
                                "block")):
        for name, kind in (("local_wavefront", "local"),
                           ("gsw_right_wavefront", "gsw_right")):
            jobs = make(kind == "local", dev)
            if kind == "local":
                kernel = lambda: wavefront.local_wavefront(  # noqa: E731
                    *jobs, sc, GAP, True)
                plain = lambda: wavefront.local_wavefront_reference(  # noqa: E731
                    *jobs, sc, GAP, True)
            else:
                kernel = lambda: wavefront.gsw_right_wavefront(  # noqa: E731
                    *jobs, sc, GAP)
                plain = lambda: wavefront.gsw_right_wavefront_reference(  # noqa: E731
                    *jobs, sc, GAP)
            C, n = jobs[0].shape
            m = jobs[1].shape[1]
            plan = wavefront.graph_dp_plan(C, n, m, kind)
            want, plain_ms = once_ms(plain)
            equal, err = equal_err(kernel(), want)
            ok &= (equal and plan["design"] == design
                   and int(want[0].max()) > 0)
            bound = graph_dp_bound(kind, jobs[2].cpu().numpy(),
                                   jobs[3].cpu().numpy(), n, m)
            by = ("bytes" if bound["bytes"] > bound["operations"]
                  else "operations")
            extra[case][name] = {
                "jobs": C, "n": n, "m": m, "plan": plan,
                "equal_to_plain": equal, "max_abs_err": err,
                "ms": median_ms(kernel, runs=5), "plain_ms": plain_ms,
                "bound_ms": bound[by], "bound_by": by}
            job_cells[(case, name)] = bound["bound_job_cells_ms"]
    rows = []
    for name, (kernel, plain, bound) in cases.items():
        equal, err = equal_err(kernel(), plain())
        ok &= equal
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/gsw_dp.cu",
            "replaces": replaces[name], "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err,
            "ms": median_ms(kernel, runs=15, inner=5),
            "plain_ms": median_ms(plain, runs=3),
            "bound_ms": bound[by], "bound_by": by, "library_ms": None,
            "shape": (f"{len(nv_l)} left jobs at (n, m) = ({n_l}, {m_l}), "
                      f"{len(nv_r)} right jobs at ({n_r}, {m_r})"
                      + (": both walks" if name == "gsw_walk_pack" else "")),
            **{k: v for k, v in bound.items()
               if k not in ("bytes", "operations", "bound_job_cells_ms")}})
        if "bound_job_cells_ms" in bound:
            job_cells[("main", name)] = bound["bound_job_cells_ms"]
        if name in plans:
            rows[-1]["plan"] = plans[name]
            for case in extra:
                rows[-1][case] = extra[case][name]
        if name == "gsw_walk_pack":
            rows[-1].update(walk_path, graph_ms=graph_ms(kernel))
    emit({"phase": "graph_kernels", "tolerance": "exact",
          "kernels": [{**{k: r.get(k) for k in (
              "name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "plan", "shape", "graph_ms",
              "max_steps", "rounds", "rounds_total")},
              "bound_job_cells_ms": job_cells.get(("main", r["name"]))}
              for r in rows],
          **{case: {name: {**v, "bound_job_cells_ms": job_cells[(case, name)]}
                    for name, v in by_name.items()}
             for case, by_name in extra.items()}})
    if not ok:
        raise SystemExit("a graph kernel disagrees with its plain version "
                         "or did not take its plan")
    return rows


def phase_graph_cli(dev: torch.device) -> dict:
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch import graph as port_graph
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fastq

    g = build_graph(GRAPH_CLI_BP, 9)
    single, _ = graph_reads(g, 400, 11, "s")
    r1, _ = graph_reads(g, 200, 12, "p")
    r2, _ = graph_reads(g, 200, 13, "p")
    result = {"phase": "graph_cli", "genome_bp": GRAPH_CLI_BP,
              "nodes": len(g.nodes)}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        gg = os.path.join(tmp, "ref.gg")
        port_graph.write(gg, g)
        sizes = os.path.join(tmp, "ref.sizes")
        with open(sizes, "w") as f:
            f.write(f"chr1\t{GRAPH_CLI_BP}\n")
        paths = {}
        for name, reads in (("single", single), ("r1", r1), ("r2", r2)):
            paths[name] = os.path.join(tmp, name + ".fq")
            with open(paths[name], "w") as f:
                for r in reads:
                    f.write(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                            f"{fastq.qual_string(r.qual)}\n")
        t0 = time.perf_counter()
        for case, files in (("single", [paths["single"]]),
                            ("paired", [paths["r1"], paths["r2"]])):
            for fmt, extra in (("giraf", []), ("sam", ["-l", sizes])):
                out = {}
                for device in (dev.type, "cpu"):
                    path = os.path.join(tmp, f"{case}.{fmt}.{device}")
                    gsw_cmd.main(["align", gg, *files, "-o", path,
                                  "--device", device, *extra])
                    with open(path, "rb") as f:
                        out[device] = f.read()
                equal = out[dev.type] == out["cpu"]
                lines = out[dev.type].decode().splitlines()
                body = [ln for ln in lines if not ln.startswith("@")]
                result[f"{case}_{fmt}"] = {"card_equals_cpu": equal,
                                           "lines": len(body)}
                ok &= equal and len(body) == 400
        result["cli_s"] = time.perf_counter() - t0
    emit(result)
    if not ok:
        raise SystemExit("graph CLI output on the card differs from the CPU")
    return result


def lowmem_pairs():
    """bench.py's lowmem batch: LOWMEM_B random pairs of LOWMEM_LEN bases,
    drawn after its two 300 bp parity pairs from the seed-3 stream."""
    rng = np.random.default_rng(LOWMEM_SEED)
    rng.integers(0, 4, (2, 300))
    rng.integers(0, 4, (2, 300))
    shape = (LOWMEM_B, LOWMEM_LEN)
    return (rng.integers(0, 4, shape).astype(np.int8),
            rng.integers(0, 4, shape).astype(np.int8))


def block_cells(d0: int, K: int, lo_lane, n: int, m: int, W: int) -> int:
    """Interior cells (1 <= i <= n, 1 <= j <= m) of diagonals d0+1..d0+K
    on lanes [lo_lane_b, lo_lane_b + W) of each pair."""
    d = np.arange(d0 + 1, d0 + K + 1)[None, :]
    lo = np.maximum(np.maximum(1, d - m), np.asarray(lo_lane)[:, None])
    hi = np.minimum(np.minimum(d - 1, n),
                    np.asarray(lo_lane)[:, None] + W - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def long_pair_blocks(dev: torch.device, sc, go: int, ge: int) -> dict:
    """affine_fwd_block and affine_bwd_window on the middle block of the
    lowmem phase's 100 kb pair (B = 1, S = 100,001 lanes, K = 4096): K6
    from the checkpoint its forward gives (a cluster whose blocks keep
    their state in a global scratch), and K7 (a window of 8,832 lanes)
    from that checkpoint and the walk's row after the blocks above it.
    Each exact against its plain version over that block, and the walk
    over K7's trace of that block."""
    from gonomics_tpu_torch.ops import wavefront

    a, b = related_pair(np.random.default_rng(37), LOWMEM_LONG,
                        same_length=False)
    alpha, beta = (torch.from_numpy(x[None]).to(dev) for x in (a, b))
    n, m, K = len(a), len(b), LOWMEM_LONG_K
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)
    nb = ck.shape[0]
    mid = nb // 2
    shape = f"block {mid} of {nb} (d0 = {mid * K}), 1 pair of {n} x {m}"

    def fwd():
        return wavefront.affine_fwd_block(alpha, beta, ck[mid], mid * K,
                                          n + m, sc, go, ge, K)

    want, plain_ms = once_ms(lambda: wavefront.affine_fwd_block_reference(
        alpha, beta, ck[mid], mid * K, n + m, sc, go, ge, K))
    got = fwd()
    torch.cuda.synchronize()
    k6 = {"n": n, "m": m, "K": K, "shape": shape,
          "equal_to_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
          "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                             for g, w in zip(got, want)),
          "next_checkpoint_equal": torch.equal(want[0], ck[mid + 1]),
          "ms": median_ms(fwd, runs=3), "plain_ms": plain_ms,
          **wavefront.fwd_block_plan(1, n, dev)}
    # the walk's row at the entry of block mid
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((1,), n, dtype=torch.int32, device=dev)
    j = torch.full((1,), m, dtype=torch.int32, device=dev)
    later = list(reversed(range(mid + 1, nb)))
    wavefront.lowmem_backward(i, j, k, [blk * K for blk in later],
                              [ck[blk] for blk in later], alpha, beta, sc, go,
                              ge, K)

    def bwd():
        return wavefront.affine_bwd_window(alpha, beta, ck[mid], mid * K, i,
                                           sc, go, ge, K)

    want, plain_ms = once_ms(lambda: wavefront.affine_bwd_window_reference(
        alpha, beta, ck[mid], mid * K, i, sc, go, ge, K))
    got = bwd()
    torch.cuda.synchronize()
    k7 = {"n": n, "m": m, "K": K, "shape": shape,
          "equal_to_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
          "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                             for g, w in zip(got, want)),
          "ms": median_ms(bwd, runs=5), "plain_ms": plain_ms,
          **wavefront.bwd_window_plan(1, n, K, dev)}
    # the walk over that block's trace, from the same row
    trace, wlo = want

    def walk(fn):
        return lambda: fn(trace, wlo, mid * K, i.clone(), j.clone(),
                          k.clone())

    wi, wj, wk = i.clone(), j.clone(), k.clone()
    ops_want, walk_plain_ms = once_ms(
        lambda: wavefront.lowmem_walk_block_reference(trace, wlo, mid * K,
                                                      wi, wj, wk))
    gi, gj, gk = i.clone(), j.clone(), k.clone()
    ops_got = wavefront.lowmem_walk_block(trace, wlo, mid * K, gi, gj, gk)
    torch.cuda.synchronize()
    pairs = list(zip((ops_got, gi, gj, gk), (ops_want, wi, wj, wk)))
    walk_row = {"n": n, "m": m, "K": K, "shape": shape,
                "equal_to_plain": all(torch.equal(g, w) for g, w in pairs),
                "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                                   for g, w in pairs),
                "steps": int((ops_want < 3).sum()),
                "ms": median_ms(walk(wavefront.lowmem_walk_block), runs=5,
                                inner=5),
                "plain_ms": walk_plain_ms}
    return {"affine_fwd_block": k6, "affine_bwd_window": k7,
            "lowmem_walk_block": walk_row}


def phase_lowmem_kernels(dev: torch.device) -> list[dict]:
    """affine_fwd_block (K6), affine_bwd_window (K7) and lowmem_walk_block
    at the full-width shape, each on the block in the middle of the
    forward, from the checkpoint and walk state the main path gives it."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    K, n = LOWMEM_K, LOWMEM_LEN
    m, B = n, LOWMEM_B
    alpha, beta = (torch.from_numpy(x).to(dev) for x in lowmem_pairs())
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)
    nb = ck.shape[0]
    mid = nb // 2
    d0 = mid * K
    # the walk's state at the entry of block mid: the backward of the
    # blocks after it
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((B,), n, dtype=torch.int32, device=dev)
    j = torch.full((B,), m, dtype=torch.int32, device=dev)
    later = list(reversed(range(mid + 1, nb)))
    wavefront.lowmem_backward(i, j, k, [b * K for b in later],
                              [ck[b] for b in later], alpha, beta, sc, go, ge,
                              K)
    W = wavefront.window_width(n, K)
    walk_from = (i.clone(), j.clone(), k.clone())

    def fwd():
        return wavefront.affine_fwd_block(alpha, beta, ck[mid], d0, n + m, sc,
                                          go, ge, K)

    def fwd_plain():
        return wavefront.affine_fwd_block_reference(alpha, beta, ck[mid], d0,
                                                    n + m, sc, go, ge, K)

    def bwd():
        return wavefront.affine_bwd_window(alpha, beta, ck[mid], d0, i, sc,
                                           go, ge, K)

    def bwd_plain():
        return wavefront.affine_bwd_window_reference(alpha, beta, ck[mid], d0,
                                                     i, sc, go, ge, K)

    trace, wlo = bwd_plain()

    def walk(fn):
        # a fresh copy of the walk state each call (three 64-byte copies)
        return lambda: fn(trace, wlo, d0, *(t.clone() for t in walk_from))

    def equal_err(got, want):
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    fwd_want = fwd_plain()
    checks = {"affine_fwd_block": equal_err(fwd(), fwd_want),
              "affine_bwd_window": equal_err(bwd(), (trace, wlo))}
    wi, wj, wk = (t.clone() for t in walk_from)
    ops_want = wavefront.lowmem_walk_block_reference(trace, wlo, d0, wi, wj,
                                                     wk)
    gi, gj, gk = (t.clone() for t in walk_from)
    ops_got = wavefront.lowmem_walk_block(trace, wlo, d0, gi, gj, gk)
    checks["lowmem_walk_block"] = equal_err((ops_got, gi, gj, gk),
                                            (ops_want, wi, wj, wk))
    # the forward's end state is the next checkpoint of the main path
    next_ck = torch.equal(fwd_want[0], ck[mid + 1])

    # bounds from this run's inputs: bytes each input read once and each
    # output written once, and the int32 operations the cells need
    S = n + 1
    fwd_cells = block_cells(d0, K, np.zeros(B, np.int64), n, m, S)
    fwd_bytes = B * (n + m) + 100 + 4 * 6 * B * S + 4 * (6 + 3) * B * S
    wlo_np = wlo.cpu().numpy()
    bwd_cells = block_cells(d0, K, wlo_np, n, m, W)
    # the window's part of the checkpoint, of alpha and of beta (W + K
    # columns), i; the trace and wlo
    bwd_bytes = (4 * 6 * B * W + B * W + B * (W + K) + 4 * B + 100
                 + K * B * W + 4 * B)
    steps = int((ops_want < 3).sum())
    walk_bytes = steps + K * B + 4 * 4 * B + 3 * 4 * B
    bounds = {
        "affine_fwd_block": {
            "bytes": fwd_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": AFFINE_OPS_PER_CELL["score"] * fwd_cells
            / INT32_OPS_PER_S * 1e3, "cells": fwd_cells},
        "affine_bwd_window": {
            "bytes": bwd_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": AFFINE_OPS_PER_CELL["trace"] * bwd_cells
            / INT32_OPS_PER_S * 1e3, "cells": bwd_cells},
        "lowmem_walk_block": {
            "bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": LOWMEM_WALK_OPS_PER_STEP * steps
            / INT32_OPS_PER_S * 1e3, "steps": steps}}
    plan = wavefront.fwd_block_plan(B, n, dev)
    bwd_plan = wavefront.bwd_window_plan(B, n, K, dev)
    # K7 keeps its state in registers, the walk none
    smem = {"affine_fwd_block": plan["state_in_shared_memory"],
            "affine_bwd_window": None, "lowmem_walk_block": None}
    timings = {
        "affine_fwd_block": (median_ms(fwd, runs=5),
                             median_ms(fwd_plain, runs=1)),
        "affine_bwd_window": (median_ms(bwd, runs=15, inner=5),
                              median_ms(bwd_plain, runs=1)),
        "lowmem_walk_block": (
            median_ms(walk(wavefront.lowmem_walk_block), runs=15, inner=5),
            median_ms(walk(wavefront.lowmem_walk_block_reference), runs=1))}
    replaces = {
        "affine_fwd_block": "gonomics_tpu/ops/wavefront.py:895 "
                            "(_affine_fwd_chunked_kernel, pallas_call :991)",
        "affine_bwd_window": "gonomics_tpu/ops/wavefront.py:1007 "
                             "(_affine_bwd_window_kernel, pallas_call :1085)",
        "lowmem_walk_block": "gonomics_tpu/ops/wavefront.py:1102 "
                             "(_walk_block: jnp glue)"}
    rows = []
    for name, (equal, err) in checks.items():
        bound = bounds[name]
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        ms, plain = timings[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/wavefront.cu",
            "replaces": replaces[name], "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[by], "bound_by": by, "library_ms": None,
            "state_in_shared_memory": smem[name],
            "shape": (f"block {mid} of {nb} (d0 = {d0}), {B} pairs of "
                      f"{n} x {m}, K = {K}, W = {W}"),
            "bound_itemised": bound})
    # K6 and K7: one thread-block cluster a pair, their plans at this
    # shape, and their cases on the 100 kb pair (K6 a global scratch a
    # block, K7 a window of 8,832 lanes)
    long_pair = long_pair_blocks(dev, sc, go, ge)
    rows[0].update({"design": "cluster", "cluster": plan["cluster"],
                    "resident_clusters": plan["resident_clusters"],
                    "waves": plan["waves"],
                    "lanes_per_block": plan["lanes_per_block"],
                    "smem_bytes_per_block": plan["smem_bytes_per_block"],
                    "long_pair": long_pair["affine_fwd_block"]})
    rows[1].update({"design": "warp strips in a cluster", **bwd_plan,
                    "long_pair": long_pair["affine_bwd_window"]})
    rows[2].update({"design": "a tile at a time",
                    "long_pair": long_pair["lowmem_walk_block"]})
    emit({"phase": "lowmem_kernels", "tolerance": "exact",
          "next_checkpoint_equal": next_ck, "window_starts":
              sorted(set(wlo_np.tolist())),
          "affine_fwd_block_plan": plan,
          "affine_bwd_window_plan": bwd_plan,
          "affine_fwd_block_earlier_ms": K6_EARLIER_MS,
          "affine_fwd_block_long_pair": long_pair["affine_fwd_block"],
          "affine_bwd_window_long_pair": long_pair["affine_bwd_window"],
          "lowmem_walk_block_long_pair": long_pair["lowmem_walk_block"],
          "kernels": [{k: r[k] for k in (
              "name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "state_in_shared_memory", "shape",
              "bound_itemised")} for r in rows]})
    k6_long, k7_long = (long_pair["affine_fwd_block"],
                        long_pair["affine_bwd_window"])
    if not (next_ck and all(r["equal_to_plain"] for r in rows)
            and k6_long["equal_to_plain"] and k6_long["next_checkpoint_equal"]
            and not k6_long["state_in_shared_memory"]
            and k7_long["equal_to_plain"]
            and long_pair["lowmem_walk_block"]["equal_to_plain"]
            and k7_long["window_lanes"] == wavefront.window_width(
                k7_long["n"], LOWMEM_LONG_K)):
        raise SystemExit("a lowmem kernel disagrees with its plain version")
    return rows


def phase_lowmem(dev: torch.device) -> dict:
    """The lowmem aligner on bench.py's batch (the main path of this
    slice), its gates against the full-trace kernel K2, and a 100 kb pair
    through the pairwise API."""
    from gonomics_tpu_torch import align
    from gonomics_tpu_torch.align import pairwise
    from gonomics_tpu_torch.ops import wavefront

    H = align.HUMAN_CHIMP_TWO
    go, ge = AFFINE_GAPS
    alphas, betas = lowmem_pairs()
    B, n = alphas.shape
    m = betas.shape[1]
    split = {}
    wrapped = {}

    def timed(name, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            split[name] = split.get(name, 0.0) + start.elapsed_time(end)
            return out
        return run

    for attr, name in (("lowmem_forward", "forward_ms"),
                       ("lowmem_backward", "backward_ms")):
        wrapped[attr] = getattr(wavefront, attr)
        setattr(wavefront, attr, timed(name, wrapped[attr]))
    # the main path: launch counts from this call only
    wavefront.affine_fwd_block_launches = 0
    wavefront.affine_bwd_window_launches = 0
    wavefront.lowmem_walk_launches = 0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = wavefront.affine_gap_lowmem_batch(
            alphas, betas, H, go, ge, checkersize=LOWMEM_K, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for attr, fn in wrapped.items():
            setattr(wavefront, attr, fn)
    launches = {"affine_fwd_block": wavefront.affine_fwd_block_launches,
                "affine_bwd_window": wavefront.affine_bwd_window_launches,
                "lowmem_walk_block": wavefront.lowmem_walk_launches}
    full_trace_bytes = (n + m) * B * (n + 1)
    out = {"phase": "lowmem", "pairs": B, "n": n, "m": m, "K": LOWMEM_K,
           "fwd_cluster": wavefront.fwd_block_plan(B, n, dev)["cluster"],
           "bwd_cluster": wavefront.bwd_window_plan(B, n, LOWMEM_K,
                                                    dev)["cluster"],
           "blocks": (n + m - 1) // LOWMEM_K + 1,
           "wall_ms": wall, "cells_per_s": B * n * m / wall * 1e3,
           **split, "host_ms": wall - sum(split.values()),
           "peak_device_bytes": peak,
           "full_trace_bytes": full_trace_bytes, "launches": launches}

    pairs = list(zip(alphas, betas))
    routes = [pairwise.lowmem_route(ops, i0, j0) for _, ops, i0, j0 in res]
    scores = [s for s, _, _, _ in res]
    out["routes_consume_both"] = all(
        consumed(r) == (n, m) for r in routes)
    out["routes_replay_to_score"] = all(
        replay_score(a, b, r, H, go, ge) == s
        for (a, b), r, s in zip(pairs, routes, scores))
    t0 = time.perf_counter()
    k2 = align.affine_gap_batch(pairs, H, go, ge, device=dev,
                                with_cigar=False)
    out["k2_score_mode_s"] = time.perf_counter() - t0
    out["scores_equal_k2"] = [s for s, _ in k2] == scores
    t0 = time.perf_counter()
    full = align.affine_gap_batch(pairs[:2], H, go, ge, device=dev)
    out["k2_trace_2_pairs_s"] = time.perf_counter() - t0
    out["first_2_equal_full_trace"] = [
        (s, [(c.run_length, c.op) for c in r]) for s, r in full] == [
        (s, [(c.run_length, c.op) for c in r])
        for s, r in zip(scores[:2], routes[:2])]
    del full

    # 4 related pairs of 2 kb at K = 256 (the window moves) against the CPU
    rng = np.random.default_rng(31)
    small = [related_pair(rng, LOWMEM_SMALL, same_length=True)
             for _ in range(4)]
    sa = np.stack([a for a, _ in small])
    sb = np.stack([b for _, b in small])
    on_card, on_cpu = (
        wavefront.affine_gap_lowmem_batch(sa, sb, H, go, ge,
                                          checkersize=LOWMEM_SMALL_K,
                                          device=d) for d in (dev, "cpu"))
    out["small_equal_cpu"] = all(
        (g[0], g[2], g[3]) == (w[0], w[2], w[3]) and np.array_equal(g[1], w[1])
        for g, w in zip(on_card, on_cpu))

    # one related pair of 100 kb through the pairwise API, default K
    a, b = related_pair(np.random.default_rng(37), LOWMEM_LONG,
                        same_length=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, route = align.affine_gap_lowmem(a, b, H, go, ge, device=dev)
    long_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [(k2_score, _)] = align.affine_gap_batch([(a, b)], H, go, ge, device=dev,
                                             with_cigar=False)
    out["long_pair"] = {
        "n": len(a), "m": len(b), "K": LOWMEM_LONG_K, "lowmem_s": long_s,
        "k2_score_mode_s": time.perf_counter() - t0,
        "cigar_runs": len(route),
        "consumes_both": consumed(route) == (len(a), len(b)),
        "replays_to_score": replay_score(a, b, route, H, go, ge) == score,
        "score_equal_k2": score == k2_score}
    emit(out)
    lp = out["long_pair"]
    if not (all(v > 0 for v in launches.values())
            and out["routes_consume_both"] and out["routes_replay_to_score"]
            and out["scores_equal_k2"] and out["first_2_equal_full_trace"]
            and out["small_equal_cpu"] and lp["consumes_both"]
            and lp["replays_to_score"] and lp["score_equal_k2"]):
        raise SystemExit("lowmem check failed")
    return out


def stream_batch(dev):
    """bench.py's stream batch: P x B random pairs of L x L (seeds 0, 1)."""
    shape = (SCORE_P, SCORE_B, SCORE_L)
    return tuple(torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, shape).astype(np.int8)).to(dev) for seed in (0, 1))


def random_score_batch(B: int, n: int, m: int, seed: int, dev):
    """B random pairs padded to (n, m) with code 4, each of its own
    n_b x m_b (pair 0 the full widths), codes 0..4; alpha, beta, fin."""
    rng = np.random.default_rng(seed)
    nb, mb = rng.integers(1, n + 1, B), rng.integers(1, m + 1, B)
    nb[0], mb[0] = n, m
    alpha = rng.integers(0, 5, (B, n)).astype(np.int8)
    beta = rng.integers(0, 5, (B, m)).astype(np.int8)
    alpha[np.arange(n) >= nb[:, None]] = 4
    beta[np.arange(m) >= mb[:, None]] = 4
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (alpha, beta, (nb + mb).astype(np.int32)))


def phase_score_kernels(dev: torch.device) -> list[dict]:
    """affine_stream (K8) and affine_score_diag (through K9's contract and
    K2's score mode) against their plain versions at full size and on edge
    cases, exact."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)

    def stream(a, b):
        return wavefront.wavefront_affine_stream(
            a, b, sc, n=a.shape[2], m=b.shape[2], gap_open=go, gap_extend=ge)

    def stream_plain(a, b):
        return wavefront.affine_stream_reference(a, b, sc, go, ge)

    def blocked(a, b, f, r_rows):
        return wavefront.wavefront_align_blocked(
            a, b, f, sc, n=a.shape[1], m=b.shape[1], gap_open=go,
            gap_extend=ge, r_rows=r_rows)

    def blocked_plain(a, b, f, r_rows):
        return wavefront.affine_block_reference(a, b, f, sc, go, ge, r_rows)

    def k2_score(a, b, f):
        return wavefront.affine_wavefront(a, b, f, sc, go, ge, False)

    def k2_score_plain(a, b, f):
        return wavefront.affine_wavefront_reference(a, b, f, sc, go, ge,
                                                    False)

    def check(kernel, plain, args) -> dict:
        """The kernel against its plain version; the plain call timed."""
        got = kernel(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args)
        end.record()
        end.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        return {"equal_to_plain": torch.equal(got, want), "max_abs_err": err,
                "plain_ms": start.elapsed_time(end)}

    L, P, B, R = SCORE_L, SCORE_P, SCORE_B, SCORE_R
    sa, sb = stream_batch(dev)
    ba, bb, bf, dims = pair_batch(B, L, L, seed=41, dev=dev)
    # phase 7's score-mode batch
    ka, kb, kf, kdims = pair_batch(PAIR_B_SCORE, PAIR_LEN, PAIR_LEN,
                                   seed=PAIR_B_SCORE + len("affine"), dev=dev)
    full = {
        "affine_stream": (stream, stream_plain, (sa, sb),
                          f"{P} x {B} random pairs of {L} x {L}"),
        "affine_block": (blocked, blocked_plain, (ba, bb, bf, R),
                         f"{B} related pairs padded to {L} x {L} (n_b = "
                         f"{int(dims[:, 0].min())}-{L}, m_b = "
                         f"{int(dims[:, 1].min())}-{L}), r_rows = {R}"),
        "k2_score_mode": (k2_score, k2_score_plain, (ka, kb, kf),
                          f"{PAIR_B_SCORE} related pairs padded to "
                          f"{PAIR_LEN} x {PAIR_LEN} (n_b = "
                          f"{int(kdims[:, 0].min())}-{PAIR_LEN}, m_b = "
                          f"{int(kdims[:, 1].min())}-{PAIR_LEN})")}

    def codes(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, 5, shape).astype(np.int8)).to(dev)

    def k2_batch(B, n, m, seed, fin_of=lambda f: f):
        """random_score_batch with fin_b = fin_of(n_b + m_b)."""
        a, b, f = random_score_batch(B, max(n, 1), m, seed, dev)
        return (a[:, :n].contiguous(), b,
                fin_of(f).to(torch.int32).contiguous())

    def edges_of(n, m):
        def fin_of(f):
            f = f.clone()
            f[:4] = torch.tensor([n + m + 1, 0, 1, n + m])[:len(f)]
            return f
        return fin_of

    edges = [
        ("affine_stream", "P = 2, m even and m > n (300 x 512)",
         (codes((2, 16, 300), 51), codes((2, 16, 512), 52))),
        ("affine_stream", "n = 1 (1 x 7)",
         (codes((2, 8, 1), 53), codes((2, 8, 7), 54))),
        ("affine_stream", "n below one strip, odd m (100 x 301)",
         (codes((2, 16, 100), 58), codes((2, 16, 301), 59))),
        ("affine_stream", "m much wider than n (64 x 4096)",
         (codes((2, 4, 64), 60), codes((2, 4, 4096), 61))),
        ("affine_block", "r_rows = 384 not dividing n = 1000",
         (*random_score_batch(16, 1000, 700, 55, dev), 384)),
        ("affine_block", "n = 1, r_rows = 512",
         (*random_score_batch(4, 1, 50, 56, dev), 512)),
        ("affine_block", "r_rows + 1 = 1501 > 1024 lanes",
         (*random_score_batch(8, 3000, 300, 57, dev), 1500)),
        ("k2_score_mode", "fin_b 1-3 below n_b + m_b (300 x 200)",
         k2_batch(12, 300, 200, 62,
                  lambda f: f - 1 - torch.arange(len(f), device=dev) % 3)),
        ("k2_score_mode", "fin_b past n + m, 0, 1 and n + m (90 x 70)",
         k2_batch(6, 90, 70, 63, edges_of(90, 70))),
        ("k2_score_mode", "m < n (600 x 50)", k2_batch(8, 600, 50, 64)),
        ("k2_score_mode", "n = 0 (0 x 7)",
         k2_batch(3, 0, 7, 65, lambda f: f - 1)),
        ("k2_score_mode", "one pair of 20,000 x 300 (79 strips)",
         k2_batch(1, 20_000, 300, 66))]
    cases = []
    for name, (kernel, plain, args, what) in full.items():
        cases.append({"kernel": name, "case": "full size: " + what,
                      **check(kernel, plain, args)})
    for name, what, args in edges:
        kernel, plain = full[name][:2]
        cases.append({"kernel": name, "case": what,
                      **check(kernel, plain, args)})
    ok = all(c["equal_to_plain"] for c in cases)

    # bounds from this run's inputs: the stream's cells are P B n m;
    # affine_score_diag's are those on or before each pair's diagonal
    # fin_b, over nb r_rows padded rows for K9 and n rows for K2
    nb = -(-L // R)
    bounds = {
        "affine_stream": wavefront_bound(
            "affine", "score", np.tile([L, L], (P * B, 1)), L, L,
            results=P * B),
        "affine_block": wavefront_bound(
            "affine", "score", dims, L, L, results=nb * B * (R + 1),
            cells=diagonal_cells(nb * R, L, bf.cpu().numpy())),
        "k2_score_mode": wavefront_bound(
            "affine", "score", kdims, PAIR_LEN, PAIR_LEN,
            cells=diagonal_cells(PAIR_LEN, PAIR_LEN, kf.cpu().numpy()))}
    times = {"affine_stream": median_ms(lambda: stream(sa, sb), runs=10,
                                        inner=2),
             "affine_block": median_ms(lambda: blocked(ba, bb, bf, R),
                                       runs=10, inner=2),
             "k2_score_mode": median_ms(lambda: k2_score(ka, kb, kf),
                                        runs=10, inner=2)}
    plans = {"affine_stream": wavefront.stream_launch_plan(P * B, L, L),
             "affine_block": wavefront.score_diag_launch_plan(B, nb * R, L),
             "k2_score_mode": wavefront.score_diag_launch_plan(
                 PAIR_B_SCORE, PAIR_LEN, PAIR_LEN)}
    summary = {}
    for name, bound in bounds.items():
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        mine = [c for c in cases if c["kernel"] == name]
        summary[name] = {
            "shape": full[name][3], "ms": times[name],
            "plain_ms": mine[0]["plain_ms"], "bound_ms": bound[by],
            "bound_by": by, "cells": bound["cells"], "plan": plans[name],
            "equal_to_plain": all(c["equal_to_plain"] for c in mine),
            "max_abs_err": max(c["max_abs_err"] for c in mine)}
    emit({"phase": "score_kernels", "tolerance": "exact", "cases": cases,
          "kernels": summary})
    if not ok:
        raise SystemExit("a score kernel disagrees with its plain version")
    common = {"route": "cuda", "source": "gonomics_tpu_torch/csrc/wavefront.cu",
              "launches": None, "tolerance": "exact", "library_ms": None}
    row_keys = ("equal_to_plain", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "shape", "cells")
    k2 = summary["k2_score_mode"]
    return [
        {"name": "affine_stream", **common,
         "replaces": "gonomics_tpu/ops/wavefront.py:1306 "
                     "(_affine_stream_kernel, pallas_call :1507 in "
                     "wavefront_affine_stream :1449)",
         **{k: summary["affine_stream"][k] for k in row_keys}},
        {"name": "affine_score_diag", **common,
         "replaces": "gonomics_tpu/ops/wavefront.py:466 "
                     "(_affine_block_kernel, pallas_call :620 in "
                     "wavefront_align_blocked :569) and :94 (_affine_kernel's "
                     "score mode, pallas_call :1584)",
         **{k: summary["affine_block"][k] for k in row_keys},
         "equal_to_plain": (summary["affine_block"]["equal_to_plain"]
                            and k2["equal_to_plain"]),
         "max_abs_err": max(summary["affine_block"]["max_abs_err"],
                            k2["max_abs_err"]),
         "k2_score_mode": {k: k2[k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by", "cells")}}]


def phase_score(dev: torch.device) -> dict:
    """bench.py's stage_score_stream on the card: its parity gate against
    the plain versions on the CPU, one call each of K2's score mode, the
    stream (K8) and the blocked entry point (K9's contract) on the
    stream's batch (the main path of this slice, launch counts from it)
    with the gate that all three agree on every pair, their peak device
    memory, the plans of affine_score_diag (which K2's score mode and the
    blocked entry point launch), and G cells/s of each at bench.py's
    sizes."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    kw = dict(gap_open=go, gap_extend=ge)

    def k2(a, b):
        n, m = a.shape[1], b.shape[1]
        fin = torch.full((a.shape[0],), n + m, dtype=torch.int32,
                         device=a.device)
        return wavefront.wavefront_align(a, b, fin, HUMAN_CHIMP_TWO,
                                         with_trace=False, **kw)[:, n]

    def k8(a, b):
        return wavefront.wavefront_affine_stream(
            a, b, HUMAN_CHIMP_TWO, n=a.shape[2], m=b.shape[2], **kw)

    def k9(a, b, r_rows):
        n, m = a.shape[1], b.shape[1]
        fin = torch.full((a.shape[0],), n + m, dtype=torch.int32,
                         device=a.device)
        res = wavefront.wavefront_align_blocked(
            a, b, fin, HUMAN_CHIMP_TWO, n=n, m=m, r_rows=r_rows, **kw)
        k = (n - 1) // r_rows
        return res[k, :, n - k * r_rows]

    # bench.py's compiled-parity gate, held against the plain versions on
    # the CPU (bench.py holds it against the numpy oracle)
    B0, L0, P0 = SCORE_B0, SCORE_L0, SCORE_P0
    rng = np.random.default_rng(5)
    a0 = torch.from_numpy(rng.integers(0, 4, (B0, L0)).astype(np.int8))
    b0 = torch.from_numpy(rng.integers(0, 5, (B0, L0)).astype(np.int8))
    als = torch.from_numpy(rng.integers(0, 4, (P0, B0, L0)).astype(np.int8))
    bes = torch.from_numpy(rng.integers(0, 5, (P0, B0, L0)).astype(np.int8))
    r0 = L0 // 3 + 8  # three blocks, the last one short
    gate = {
        "k2_b0": torch.equal(k2(a0.to(dev), b0.to(dev)).cpu(), k2(a0, b0)),
        "stream_p0": torch.equal(k8(als.to(dev), bes.to(dev)).cpu(),
                                 k8(als, bes)),
        "blocked_b0": torch.equal(k9(a0.to(dev), b0.to(dev), r0).cpu(),
                                  k9(a0, b0, r0))}

    # the main path: launch counts from these three calls only
    sa, sb = stream_batch(dev)
    P, B, L, R = SCORE_P, SCORE_B, SCORE_L, SCORE_R
    flat_a, flat_b = sa.reshape(P * B, L), sb.reshape(P * B, L)
    wavefront.affine_launches = wavefront.affine_block_launches = 0
    wavefront.affine_stream_launches = wavefront.affine_score_diag_launches = 0
    scores, peak = {}, {}
    for name, fn in (("k2", lambda: k2(flat_a, flat_b)),
                     ("stream", lambda: k8(sa, sb).reshape(-1)),
                     ("blocked", lambda: k9(flat_a, flat_b, R))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        scores[name] = fn()
        torch.cuda.synchronize()
        peak[name] = {"peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "above_inputs_bytes":
                          torch.cuda.max_memory_allocated(dev) - before}
    launches = {"affine_stream": wavefront.affine_stream_launches,
                "affine_score_diag": wavefront.affine_score_diag_launches}
    wrapper_launches = {"k2_score_mode": wavefront.affine_launches,
                        "blocked": wavefront.affine_block_launches}
    agree = (torch.equal(scores["k2"], scores["stream"])
             and torch.equal(scores["k2"], scores["blocked"]))

    # G cells/s at bench.py's sizes: K2 on its B = 256 batch, the stream
    # on P x B, the blocked kernel on K2's batch
    a1, b1 = (torch.from_numpy(np.random.default_rng(s).integers(
        0, 4, (B, L)).astype(np.int8)).to(dev) for s in (2, 3))
    timed = {"k2": (lambda: k2(a1, b1), B * L * L, 15, 5),
             "stream": (lambda: k8(sa, sb), P * B * L * L, 10, 2),
             "blocked": (lambda: k9(a1, b1, R), B * L * L, 10, 2)}
    rates = {}
    for name, (fn, cells, runs, inner) in timed.items():
        ms = median_ms(fn, runs=runs, inner=inner)
        rates[name] = {"ms": ms, "cells": cells,
                       "g_cells_per_s": cells / ms / 1e6}
    nb = -(-L // R)
    plans = {"shared_batch": {
                 "k2_score_mode": wavefront.score_diag_launch_plan(P * B, L, L),
                 "blocked": wavefront.score_diag_launch_plan(P * B, nb * R, L)},
             "rates": {
                 "k2_score_mode": wavefront.score_diag_launch_plan(B, L, L),
                 "blocked": wavefront.score_diag_launch_plan(B, nb * R, L)}}
    out = {"phase": "score", "parity_gate": gate,
           "shared_batch": f"{P} x {B} random pairs of {L} x {L}",
           "all_three_agree": agree, "launches": launches,
           "wrapper_launches": wrapper_launches,
           "peak_device_memory": peak, "r_rows": R,
           "affine_score_diag_plans": plans, "rates": rates}
    emit(out)
    if not (all(gate.values()) and agree
            and all(v > 0 for v in launches.values())
            and all(v > 0 for v in wrapper_launches.values())):
        raise SystemExit("score check failed")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    info = phase_device()
    rows = phase_kernels(dev)
    e2e, long_batch, huge_batch = phase_end_to_end(dev, 100_000_000)
    rows += phase_long_read_kernels(dev, long_batch)
    phase_huge_read(dev, huge_batch)
    del long_batch, huge_batch
    phase_cli(dev, CLI_BP)
    mesh = phase_mesh(dev, CLI_BP)
    walk_row, k4_mesh = phase_mesh_kernels(dev, mesh.pop("inputs"))
    rows.append(walk_row)
    rows += phase_pairwise_kernels(dev)
    pairwise = phase_pairwise(dev)
    phase_pairwise_cli()
    graph, waves = phase_graph(dev)
    rows += phase_graph_kernels(dev, waves, graph["dims"])
    del waves
    phase_graph_cli(dev)
    rows += phase_lowmem_kernels(dev)
    lowmem = phase_lowmem(dev)
    rows += phase_score_kernels(dev)
    score = phase_score(dev)
    launches = {**e2e["launches"], **pairwise["launches"],
                **graph["launches"], **lowmem["launches"],
                **score["launches"],
                "local_walk_pack": mesh["launches"]["local_walk_pack"]}
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] == "local_wavefront":  # K4 on the mesh path too
            r["mesh_launches"] = mesh["launches"]["local_wavefront"]
            r["mesh_path"] = {k: k4_mesh[k] for k in (
                "shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "equal_to_plain")}
        if r.get("kernel") == "trace_diag":
            r["trace_diag_launches"] = launches["trace_diag"]
    emit({"phase": "done", "total_s": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
