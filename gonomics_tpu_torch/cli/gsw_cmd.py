"""gsw align on the PyTorch port: the counterpart of
``gonomics_tpu/cli/gsw_cmd.py`` (``align_cmd``, :214-257, ``_align_tpu``,
:41-144, and ``_align_tpu_graph``, :147-198).

    python -m gonomics_tpu_torch.cli.gsw_cmd align ref.fa R1.fq [R2.fq] \
        [-i 32] [-w 32] [-m humanChimp] [-l ref.sizes] -o out.giraf
    python -m gonomics_tpu_torch.cli.gsw_cmd align ref.fa R1.fq [R2.fq] \
        --engine tpu -o out.sam

``--engine host`` (the default, as in the JAX CLI) aligns against a
genome graph with ``graph_align.GraphAligner``: a .gg/.sg reference as
read, a .fa reference as a linear graph of one node a record
(``graph.from_fasta``). It writes giraf, or SAM when ``-l`` names a
.sizes file, byte-identical to the JAX ``gsw align`` without
``--engine``. ``--engine tpu`` aligns a .fa reference in batches with
``read_align.ReadAligner`` and writes SAM, byte-identical to ``gsw align
--engine tpu``; a .gg/.sg reference goes to ``GraphAligner`` as with the
host engine. Both engines run their DPs on the card; ``--device cpu``
runs the kernels' plain versions on the CPU. ``-t/--threads`` is
accepted and unused, as in the JAX CLI. ``--profile DIR`` runs the
alignment under ``torch.profiler`` and writes its trace to
DIR/gsw_align.pt.trace.json. ``--mesh`` with ``--engine tpu`` and a .fa
reference shards each batch data-parallel over every CUDA device of the
process (``parallel.make_mesh(data=<devices>, seq=1)``; one CPU device
with ``--device cpu``), as the JAX CLI does over its local devices: each
read's whole (L, L + 48) grid on the card, a trace of (2 L + 48)(L + 1)
bytes a read, and the same SAM. ``--multihost`` and ``--index-sharding
prefix`` with a .fa reference are not ported yet and exit with an error
that names their ROADMAP item. The host engine, and a .gg/.sg reference
on either engine, ignore all three, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import fileio, graph as graphmod
from ..align.matrices import BY_NAME, HUMAN_CHIMP_TWO
from ..graph_align import GraphAligner
from ..io import fasta, fastq as fastqio, giraf as girafio
from ..io.chrom_info import read_to_slice
from ..parallel import make_mesh
from ..read_align import ReadAligner


def _progress(tool: str, n: int, t0: float, final: bool = False) -> None:
    """Reads/s and wall-clock line on stderr, as the JAX CLI prints it."""
    dt = max(time.perf_counter() - t0, 1e-9)
    tag = "finished" if final else "progress"
    print(f"{tool}: {tag} {n} reads in {dt:.1f}s ({n / dt:.0f} reads/s)",
          file=sys.stderr)


def _refuse_unported(args) -> None:
    for flag, on in (("--multihost", args.multihost),
                     ("--index-sharding prefix",
                      args.index_sharding == "prefix")):
        if on:
            raise SystemExit(f"gsw align: {flag} is not ported yet (ROADMAP "
                             "queue 1, item 7: multi-device paths)")


def _load_reference(path: str):
    """A .gg/.sg graph and its node names (each node's id), or the linear
    graph of a .fa reference and its record names."""
    if path.endswith((".gg", ".sg")):
        g = graphmod.read(path)
        return g, {n.id: str(n.id) for n in g.nodes}
    return graphmod.from_fasta(fasta.read(path))


def _select_matrix(name: str):
    if name in ("humanChimp", "humanChimpTwo"):
        return HUMAN_CHIMP_TWO
    if name in BY_NAME:
        return np.asarray(BY_NAME[name], np.int64)
    raise SystemExit(f"unknown score matrix: {name}")


def _align_graph(args) -> None:
    """Graph (or a .fa reference's linear graph) -> giraf, or SAM with ``-l x.sizes``: seeds and
    traversal on the host, the extension DPs of each batch on the device
    (``graph_align.GraphAligner``)."""
    g, names = _load_reference(args.files[0])
    aligner = GraphAligner(g, seed_len=args.index, step_size=args.window,
                           scores=_select_matrix(args.matrix),
                           node_names=names, device=args.device)
    host = aligner.host
    to_sam = args.liftover.endswith(".sizes")
    out = fileio.easy_create(args.out)
    if to_sam:
        chroms = read_to_slice(args.liftover)
        for line in (["@HD\tVN:1.6\tSO:unsorted"]
                     + [f"@SQ\tSN:{c.name}\tLN:{c.size}" for c in chroms]):
            out.write(line + "\n")

    t0 = time.perf_counter()
    n_reads = 0
    if len(args.files) == 3:
        pairs = fastqio.read_pairs_big(args.files[1], args.files[2])
        for i in range(0, len(pairs), args.batch):
            batch = pairs[i:i + args.batch]
            for a, b in aligner.align_pair_batch(batch):
                if to_sam:
                    sa, sb = host.pair_to_sam(a, b)
                    out.write(sa.to_string() + "\n")
                    out.write(sb.to_string() + "\n")
                else:
                    out.write(girafio.to_string(a) + "\n")
                    out.write(girafio.to_string(b) + "\n")
            n_reads += 2 * len(batch)
            _progress("gsw", n_reads, t0)
    else:
        reads = [fastqio.to_big(fq) for fq in fastqio.read(args.files[1])]
        for i in range(0, len(reads), args.batch):
            batch = reads[i:i + args.batch]
            for a in aligner.align_batch(batch):
                a.flag = host._giraf_flags(a)
                if to_sam:
                    out.write(host.giraf_to_sam(a).to_string() + "\n")
                else:
                    out.write(girafio.to_string(a) + "\n")
            n_reads += len(batch)
            _progress("gsw", n_reads, t0)
    if args.out not in ("-", "/dev/stdout", "stdout"):
        out.close()
    _progress("gsw", n_reads, t0, final=True)


def align_cmd(args) -> None:
    """The host engine, and a graph reference on either engine, go to
    ``_align_graph`` before any multi-device flag is read, as in the JAX
    CLI (gsw_cmd.py:55-57). The tpu engine's linear .fa reference -> SAM
    through a three-stage pipeline: batch i+1's host seeding (main
    thread) overlaps batch i's device work (launched without waiting) and
    batch i-1's SAM assembly (worker thread); writes drain in order on
    the main thread."""
    if len(args.files) not in (2, 3):
        raise SystemExit("gsw align: want ref[.gg/.fa] R1.fq [R2.fq]")
    if args.engine == "host" or args.files[0].endswith((".gg", ".sg")):
        _align_graph(args)
        return
    _refuse_unported(args)
    mesh = None
    if args.mesh:
        mesh = (make_mesh(devices=["cpu"], data=1) if args.device == "cpu"
                else make_mesh(data=torch.cuda.device_count(), seq=1))
    records = fasta.read(args.files[0])
    al = ReadAligner(records, index_mode=args.index_mode,
                     index_step=args.index_step, device=args.device,
                     mesh=mesh)
    out = fileio.easy_create(args.out)
    for line in al.header().text:
        out.write(line + "\n")

    t0 = time.perf_counter()
    n_done = 0

    def emit(sams) -> None:
        nonlocal n_done
        if isinstance(sams, str):  # native bulk-formatted SAM text
            out.write(sams)
            n_done += sams.count("\n")
        else:
            for s in sams:
                out.write(s.to_string() + "\n")
            n_done += len(sams)
        _progress("gsw", n_done, t0)

    if len(args.files) == 3:
        r1 = fastqio.read(args.files[1])
        r2 = fastqio.read(args.files[2])
        inputs = [list(zip(r1[i:i + args.batch], r2[i:i + args.batch]))
                  for i in range(0, len(r1), args.batch)]
        dispatch, finish = al.align_pairs_async, al.finish_pairs
    else:
        reads = fastqio.read(args.files[1])
        inputs = [reads[i:i + args.batch]
                  for i in range(0, len(reads), args.batch)]
        dispatch, finish = al.align_batch_async, al.finish_batch_lines
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque()
        for batch in inputs:
            futs.append(ex.submit(finish, dispatch(batch)))
            while len(futs) > 2:
                emit(futs.popleft().result())
        while futs:
            emit(futs.popleft().result())
    _progress("gsw", n_done, t0, final=True)
    if args.out not in ("-", "/dev/stdout", "stdout"):
        out.close()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="gsw")
    sub = p.add_subparsers(dest="cmd", required=True)
    al = sub.add_parser("align", help="align single or paired end fastqs "
                                      "to a linear reference (SAM) or a "
                                      "genome graph (giraf, or SAM with -l)")
    al.add_argument("files", nargs="+",
                    help="ref[.gg/.fa] R1.fastq [R2.fastq]")
    al.add_argument("-i", "--index", type=int, default=32,
                    help="host engine and graph references: seed length")
    al.add_argument("-w", "--window", type=int, default=32,
                    help="host engine and graph references: genome step "
                         "of the seed index")
    al.add_argument("-t", "--threads", type=int, default=4,
                    help="accepted and unused, as in the JAX CLI")
    al.add_argument("-m", "--matrix", default="humanChimp",
                    help="host engine and graph references: score matrix")
    al.add_argument("-l", "--liftover", default="",
                    help="host engine and graph references: a .sizes "
                         "file, for SAM output")
    al.add_argument("-o", "--out", default="/dev/stdout")
    al.add_argument("--engine", default="host", choices=["host", "tpu"],
                    help="host: the graph aligner, giraf (SAM with -l), "
                         "a .fa reference as a linear graph; tpu: the "
                         "batched read aligner, SAM, for .fa references. "
                         "Both run their DPs on --device")
    al.add_argument("--batch", type=int, default=2048,
                    help="reads per device batch")
    al.add_argument("--index-mode", default="dense",
                    choices=["dense", "sparse"],
                    help="seed index: dense (code,pos) table, or the "
                         "sparse two-level table of step-sampled "
                         "positions (for Gbp-class references)")
    al.add_argument("--index-step", type=int, default=8,
                    help="genome sampling step of the sparse index")
    al.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the DPs run; cpu runs the kernels' "
                         "plain PyTorch versions")
    al.add_argument("--index-sharding", default="replicated",
                    choices=["replicated", "prefix"],
                    help="tpu engine: prefix is not ported yet")
    al.add_argument("--mesh", action="store_true",
                    help="tpu engine, .fa reference: shard each batch "
                         "data-parallel over every CUDA device (the whole "
                         "local DP a read)")
    al.add_argument("--multihost", action="store_true",
                    help="tpu engine: not ported yet")
    al.add_argument("--profile", default="",
                    help="write a torch.profiler trace of the alignment to "
                         "this directory")
    a = p.parse_args(argv)
    if a.profile:
        _profiled_align(a)
    else:
        align_cmd(a)


def _profiled_align(args) -> None:
    """align_cmd under torch.profiler (host activity, and the card's when
    the DPs run there); the trace goes to DIR/gsw_align.pt.trace.json."""
    activities = [ProfilerActivity.CPU]
    if args.device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        align_cmd(args)
        if args.device != "cpu":
            torch.cuda.synchronize()
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile,
                                          "gsw_align.pt.trace.json"))


if __name__ == "__main__":
    main()
