#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gonomics_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device:  the card's name and power limit (nvidia-smi); builds the CUDA
            kernels and the host library from the checkout's sources.
2. kernels: a full-size batch (4096 reads x 150 bp, 198 bp windows) through
            banded_dp and banded_walk_pack, each held against its plain
            PyTorch version on the card (exact equality) and timed.
3. end_to_end: ReadAligner on a 100 Mbp seeded genome with the sparse
            index (step 8): 4 pipelined batches of 4096 x 150 bp reads;
            checks the mapped and correctly placed fractions, that junk
            stays unmapped, and that the main path launched every kernel.
4. cli:     `gsw align` of the port on a 10 Mbp genome, single and paired,
            byte-equal to the library path's SAM for the same reads.

Then the kernels line (launch counts from phase 3) and, last, one JSON
object naming the device. Without a CUDA card, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

B, L, PAD = 4096, 150, 24
W = L + 2 * PAD
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def dp_operations(n_vec: np.ndarray, m_vec: np.ndarray) -> int:
    """int32 operations banded_dp's function needs for reads of lengths
    n_vec in windows of lengths m_vec (see DP_OPS_PER_VALID_CELL)."""
    rows = np.minimum(n_vec.astype(np.int64), L)
    i = np.arange(1, L + 1)
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
    _kernels.lib()
    host.join()
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "build_s": time.perf_counter() - t0,
            "native_host_library": native.available(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def kernel_batch(seed: int):
    """B anchored (read, window) pairs: SNPs, 5 bp deletions and
    insertions, short reads, lowercase bases and junk rows."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    wins[rng.random((B, W)) < 0.001] = 4
    reads = wins[:, PAD:PAD + L].copy()
    n_vec = np.full(B, L, np.int32)
    for b in range(B):
        kind = b % 10
        if kind == 1:      # 5 bp deletion from the read
            reads[b, 75:] = wins[b, PAD + 80:PAD + 80 + L - 75]
        elif kind == 2:    # 5 bp insertion into the read
            reads[b, 80:] = reads[b, 75:L - 5].copy()
            reads[b, 75:80] = rng.integers(0, 4, 5)
        elif kind == 3:    # short read
            n_vec[b] = int(rng.integers(100, L))
            reads[b, n_vec[b]:] = 4
        elif kind == 4:    # lowercase bases
            reads[b, rng.integers(0, L, 12)] += 5
        elif kind == 5:    # junk
            reads[b] = rng.integers(0, 4, L)
        snp = rng.integers(0, L, 1 + b % 3)
        reads[b, snp] = (reads[b, snp] % 5 + 1) % 4
    return reads, wins, n_vec, np.full(B, W, np.int32)


def phase_kernels(dev: torch.device) -> list[dict]:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(dev)
                                 for x in kernel_batch(1))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    dp_args = (reads, wins, n_vec, m_vec, sc, GAP)
    got = banded.banded_dp(*dp_args)
    want = banded.banded_dp_reference(*dp_args)
    torch.cuda.synchronize()
    dp_equal = all(torch.equal(g, w) for g, w in zip(got, want))
    dp_err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                 for g, w in zip(got, want))

    bv, bi, trace = want
    score, i_star, c_star = banded.best_cell(bv, bi)
    D = banded.walk_length(L)
    walk_args = (trace, i_star, c_star, score > 0, D)
    wgot = banded.banded_walk_pack(*walk_args)
    wwant = banded.banded_walk_pack_reference(*walk_args)
    torch.cuda.synchronize()
    walk_equal = all(torch.equal(g, w) for g, w in zip(wgot, wwant))
    walk_err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(wgot, wwant))

    # bounds from this batch: bytes each input read once and each output
    # written once, and the operations this batch's cells need over the
    # int32 rate
    cells = L * B * 64
    dp_bytes = (B * L + B * W + 8 * B + 100 + 2 * B * 64 * 4 + cells)
    dp_ops = dp_operations(n_vec.cpu().numpy(), m_vec.cpu().numpy())
    dp_bound = {"bytes": dp_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": dp_ops / INT32_OPS_PER_S * 1e3}
    ops = banded.unpack_ops(wwant[2].cpu().numpy(), D)
    i0 = wwant[0].cpu().numpy()
    # the walk reads one trace cell per move, plus the cell it stops on
    steps = int((ops < 3).sum() + ((score > 0).cpu().numpy() & (i0 > 0)).sum())
    P = wwant[2].shape[1]
    walk_bytes = B * (4 + 4 + 1) + B * (4 + 4 + P) + steps
    walk_bound = {"bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": WALK_OPS_PER_STEP * steps / INT32_OPS_PER_S * 1e3}

    timings = {
        "dp": median_ms(lambda: banded.banded_dp(*dp_args), inner=20),
        "dp_plain": median_ms(lambda: banded.banded_dp_reference(*dp_args)),
        "walk": median_ms(lambda: banded.banded_walk_pack(*walk_args),
                          inner=20),
        "walk_plain": median_ms(
            lambda: banded.banded_walk_pack_reference(*walk_args)),
    }
    rows = []
    for name, equal, err, ms, plain, bound, src, rep in (
            ("banded_dp", dp_equal, dp_err, timings["dp"], timings["dp_plain"],
             dp_bound, "gonomics_tpu_torch/csrc/banded.cu",
             "gonomics_tpu/ops/wavefront.py:709 (_banded_kernel, "
             "pallas_call :850)"),
            ("banded_walk_pack", walk_equal, walk_err, timings["walk"],
             timings["walk_plain"], walk_bound,
             "gonomics_tpu_torch/csrc/banded.cu",
             "gonomics_tpu/ops/wavefront.py:789 (_banded_walk) + "
             ":874-883 (packing)")):
        by = max(bound, key=bound.get)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": None,
                     "equal_to_plain": equal, "tolerance": "exact",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound[by], "bound_by": by,
                     "library_ms": None})
    emit({"phase": "kernels", "shape": {"B": B, "L": L, "W": W},
          "dp_operations": dp_ops, "walk_steps": steps,
          "kernels": [{k: r[k] for k in ("name", "equal_to_plain",
                                         "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                      for r in rows]})
    if not (dp_equal and walk_equal):
        raise SystemExit("a kernel disagrees with its plain version")
    return rows


def make_reads(genome: np.ndarray, n: int, seed: int, prefix: str = "r"):
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


def phase_end_to_end(dev: torch.device, G: int) -> dict:
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

    def timed_device_result(*args):
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
    banded.dp_launches = banded.walk_launches = 0
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
    launches = {"banded_dp": banded.dp_launches,
                "banded_walk_pack": banded.walk_launches}

    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))
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
           "launches": launches, **checks}
    emit(out)
    if not (checks["mapped_frac"] >= 0.99 and checks["placed_frac"] >= 0.99
            and checks["junk_mapped"] == 0
            and all(v > 0 for v in launches.values())):
        raise SystemExit("end-to-end check failed")
    return out


def phase_cli(dev: torch.device, G: int) -> dict:
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fasta, fastq
    from gonomics_tpu_torch.read_align import ReadAligner

    rng = np.random.default_rng(2)
    genome = rng.integers(0, 4, G, dtype=np.int8)
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
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, paths["single"], "-o",
                      os.path.join(tmp, "single.sam"), "--device", dev.type])
        gsw_cmd.main(["align", ref, paths["r1"], paths["r2"], "-o",
                      os.path.join(tmp, "paired.sam"), "--device", dev.type])
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
    emit(result)
    if not (result["single_equal"] and result["paired_equal"]):
        raise SystemExit("CLI SAM differs from the library path")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    info = phase_device()
    rows = phase_kernels(dev)
    e2e = phase_end_to_end(dev, 100_000_000)
    phase_cli(dev, 10_000_000)
    for r in rows:
        r["launches"] = e2e["launches"][r["name"]]
    emit({"phase": "done", "total_s": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
