"""gsw on the PyTorch port: the counterpart of
``gonomics_tpu/cli/gsw_cmd.py`` (``align_cmd``, :214-257, ``_align_tpu``,
:41-144, ``_align_tpu_graph``, :147-198, and ``ggtools_cmd`` with its
helpers, :259-381).

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
bytes a read, and the same SAM. ``--index-sharding prefix`` splits the
dense seed table over the mesh's data slices and looks the read k-mers
up on their devices (the same SAM; without ``--mesh`` or
``--multihost`` it raises the JAX CLI's ValueError, no mesh).
``--multihost`` joins a process group (``parallel.init_distributed``:
torch.distributed on gloo, from ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``, as torchrun sets them), one process
a host, each with its host's devices as its mesh: process p of n aligns
the batches b with b % n == p into <out>.shard<p>, a ``#BATCH`` line
after each, and after a barrier process 0 merges the shards under the
header into the output, byte-identical to one process's (a single
process writes the output directly). The host engine, and a .gg/.sg
reference on either engine, ignore all three flags, as the JAX CLI
does.

    python -m gonomics_tpu_torch.cli.gsw_cmd ggtools in.chain -t t.fa \
        -q q.fa -f axt|vcf|gg -o out
    python -m gonomics_tpu_torch.cli.gsw_cmd ggtools in.vcf -t t.fa -o out.gg
    python -m gonomics_tpu_torch.cli.gsw_cmd ggtools in.axt -f vcf|gg \
        [-t t.fa] -o out

``ggtools`` builds and converts genome graphs on the host, as the JAX
subcommand does, byte-identical to it.
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
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from .. import dna, fileio, graph as graphmod
from ..align.matrices import BY_NAME, HUMAN_CHIMP_TWO
from ..graph_align import GraphAligner
from ..io import fasta, fastq as fastqio, giraf as girafio
from ..io import vcf as vcfio
from ..io.formats import (axt_to_string, axt_to_vcf, chain_to_axt,
                          is_axt_file, is_chain_file, read_axt, read_chain)
from ..io.chrom_info import read_to_slice
from ..parallel import (init_distributed, make_mesh, merge_shard_files,
                        process_count, process_index)
from ..read_align import ReadAligner


def _progress(tool: str, n: int, t0: float, final: bool = False) -> None:
    """Reads/s and wall-clock line on stderr, as the JAX CLI prints it."""
    dt = max(time.perf_counter() - t0, 1e-9)
    tag = "finished" if final else "progress"
    print(f"{tool}: {tag} {n} reads in {dt:.1f}s ({n / dt:.0f} reads/s)",
          file=sys.stderr)


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
    CLI (gsw_cmd.py:55-57). The tpu engine's linear .fa reference goes
    to ``_align_linear``; with ``--multihost``, in a process group that
    this process joins first and leaves at the end."""
    if len(args.files) not in (2, 3):
        raise SystemExit("gsw align: want ref[.gg/.fa] R1.fq [R2.fq]")
    if args.engine == "host" or args.files[0].endswith((".gg", ".sg")):
        _align_graph(args)
        return
    if not args.multihost:
        _align_linear(args)
        return
    init_distributed()
    try:
        _align_linear(args)
    finally:
        dist.destroy_process_group()


def _align_linear(args) -> None:
    """The tpu engine's .fa reference -> SAM, as the JAX ``_align_tpu``
    (gsw_cmd.py:41-144), through a three-stage pipeline: batch i+1's host
    seeding (main thread) overlaps batch i's device work (launched
    without waiting) and batch i-1's SAM assembly (worker thread); writes
    drain in order on the main thread. In a group of several processes,
    this process's batches go to its shard file, and after the barrier
    process 0 merges the shards."""
    mesh = None
    if args.mesh or args.multihost:
        mesh = (make_mesh(devices=["cpu"], data=1) if args.device == "cpu"
                else make_mesh(data=torch.cuda.device_count(), seq=1))
    records = fasta.read(args.files[0])
    al = ReadAligner(records, index_mode=args.index_mode,
                     index_step=args.index_step, device=args.device,
                     mesh=mesh, index_sharding=args.index_sharding)
    nproc, pid = process_count(), process_index()
    sharded_out = nproc > 1
    out_path = f"{args.out}.shard{pid}" if sharded_out else args.out
    out = fileio.easy_create(out_path)
    if not sharded_out:
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
        if sharded_out:
            out.write("#BATCH\n")
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
        for bi, batch in enumerate(inputs):
            if sharded_out and bi % nproc != pid:
                continue
            futs.append(ex.submit(finish, dispatch(batch)))
            while len(futs) > 2:
                emit(futs.popleft().result())
        while futs:
            emit(futs.popleft().result())
    _progress("gsw", n_done, t0, final=True)
    if out_path not in ("-", "/dev/stdout", "stdout"):
        out.close()
    if sharded_out:
        dist.barrier()
        if pid == 0:
            merge_shard_files(args.out,
                              [f"{args.out}.shard{p}" for p in range(nproc)],
                              header_lines=al.header().text)


def _filter_vcf_pos(vcfs: list[vcfio.Vcf]) -> list[vcfio.Vcf]:
    """Sorted, the first record at each position of a chromosome kept,
    records whose ref or alt holds N dropped; chromosomes in the order
    they are first seen (the reference iterates a Go map)."""
    vcfs = list(vcfs)
    vcfio.sort(vcfs)
    by_chrom: dict[str, list[vcfio.Vcf]] = {}
    for v in vcfs:
        by_chrom.setdefault(v.chrom, []).append(v)
    answer = []
    for chrom in by_chrom:
        encountered = set()
        for v in by_chrom[chrom]:
            if v.pos in encountered:
                continue
            encountered.add(v.pos)
            contains_n = (dna.from_string(v.ref) == dna.N).any()
            for alt in v.alt:
                if (dna.from_string(alt) == dna.N).any():
                    contains_n = True
            if not contains_n:
                answer.append(v)
    return answer


def _axts_to_vcfs(axts) -> list[vcfio.Vcf]:
    """Each block's records through ``_filter_vcf_pos``, in block order,
    then those holding an "N" dropped."""
    out = []
    for a in axts:
        for v in _filter_vcf_pos(axt_to_vcf(a)):
            if "N" not in v.ref and "N" not in v.alt[0]:
                out.append(v)
    return out


def _chains_to_axts(chain_file: str, target_fa: str, query_fa: str):
    """Each chain as an axt block over the two FASTA files' sequences."""
    chains, _ = read_chain(chain_file)
    tmap = {r.name: r.seq for r in fasta.read(target_fa)}
    qmap = {r.name: r.seq for r in fasta.read(query_fa)}
    return [chain_to_axt(c, tmap[c.t_name], qmap[c.q_name]) for c in chains]


def _variant_graph_of(vcfs, fa_file: str) -> graphmod.GenomeGraph:
    by_chrom: dict[str, list[vcfio.Vcf]] = {}
    for v in vcfs:
        by_chrom.setdefault(v.chrom, []).append(v)
    return graphmod.variant_graph(fasta.read(fa_file), by_chrom)


def ggtools_cmd(args) -> None:
    """Chain to axt, vcf or gg; vcf to gg; axt to vcf or gg."""
    in_file = args.input
    if is_chain_file(in_file):
        if not args.target or not args.query:
            raise SystemExit("Error: Must specify both target and query "
                             "fasta files...")
        axts = _chains_to_axts(in_file, args.target, args.query)
        if args.format == "axt":
            with fileio.easy_create(args.out) as f:
                for a in axts:
                    # the reference never increments its block counter:
                    # every block is written as 0
                    f.write(axt_to_string(a, 0))
        elif args.format == "vcf":
            with fileio.easy_create(args.out) as f:
                vcfio.new_write_header(f, vcfio.new_header())
                for v in _axts_to_vcfs(axts):
                    vcfio.write_vcf(f, v)
        elif args.format == "gg":
            graphmod.write(args.out, _variant_graph_of(_axts_to_vcfs(axts),
                                                       args.target))
        else:
            raise SystemExit(f"unsupported chain output format: "
                             f"{args.format}")
    elif vcfio.is_vcf_file(in_file):
        if not args.target:
            raise SystemExit("Error: Must specify target reference fasta "
                             "file...")
        records, _ = vcfio.read(in_file)
        graphmod.write(args.out, _variant_graph_of(records, args.target))
    elif is_axt_file(in_file):
        axts = read_axt(in_file)
        if args.format == "vcf":
            ans = _axts_to_vcfs(axts)
            vcfio.sort(ans)
            with fileio.easy_create(args.out) as f:
                vcfio.new_write_header(f, vcfio.new_header())
                for v in ans:
                    vcfio.write_vcf(f, v)
        elif args.format == "gg":
            graphmod.write(args.out, _variant_graph_of(_axts_to_vcfs(axts),
                                                       args.target))
        else:
            raise SystemExit(f"unsupported axt output format: {args.format}")
    else:
        raise SystemExit(f"unrecognized input file type: {in_file}")


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
                    help="tpu engine: k-mer index layout; prefix splits "
                         "the sorted (code,pos) table over the mesh's "
                         "data slices, looked up on their devices (needs "
                         "--mesh or --multihost; the same SAM)")
    al.add_argument("--mesh", action="store_true",
                    help="tpu engine, .fa reference: shard each batch "
                         "data-parallel over every CUDA device (the whole "
                         "local DP a read)")
    al.add_argument("--multihost", action="store_true",
                    help="tpu engine, .fa reference: one process a host "
                         "in a torch.distributed group (gloo; RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT from the "
                         "environment), each on its host's devices as "
                         "--mesh; process 0 merges the shard outputs "
                         "into read order")
    al.add_argument("--profile", default="",
                    help="write a torch.profiler trace of the alignment to "
                         "this directory")
    gg = sub.add_parser("ggtools", help="create and convert genome graphs "
                        "from chain, vcf and axt files")
    gg.add_argument("input", help="input file [.chain/.vcf/.axt]")
    gg.add_argument("-t", "--target", default="",
                    help="Target reference fasta file")
    gg.add_argument("-q", "--query", default="",
                    help="Query fasta file (chain inputs)")
    gg.add_argument("-f", "--format", default="",
                    help="Output format for conversions [axt/vcf/gg]")
    gg.add_argument("-o", "--out", default="/dev/stdout")
    a = p.parse_args(argv)
    if a.cmd == "ggtools":
        ggtools_cmd(a)
    elif a.profile:
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
