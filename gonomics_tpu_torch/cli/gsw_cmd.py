"""gsw align on the PyTorch port: the linear-reference branch of
``gonomics_tpu/cli/gsw_cmd.py`` (``_align_tpu``, :41-144).

    python -m gonomics_tpu_torch.cli.gsw_cmd align ref.fa R1.fq [R2.fq] -o out.sam

Reads are aligned in batches by ``read_align.ReadAligner`` on the card
(``--device cpu`` runs the kernels' plain versions on the CPU) and
written as SAM, byte-identical to ``gsw align --engine tpu``. Graph
references, ``--mesh``, ``--multihost`` and ``--index-sharding prefix``
are not ported yet and exit with an error that names their ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import fileio
from ..io import fasta, fastq as fastqio
from ..read_align import ReadAligner


def _progress(tool: str, n: int, t0: float, final: bool = False) -> None:
    """Reads/s and wall-clock line on stderr, as the JAX CLI prints it."""
    dt = max(time.perf_counter() - t0, 1e-9)
    tag = "finished" if final else "progress"
    print(f"{tool}: {tag} {n} reads in {dt:.1f}s ({n / dt:.0f} reads/s)",
          file=sys.stderr)


def _refuse_unported(args) -> None:
    if args.files[0].endswith((".gg", ".sg")):
        raise SystemExit("gsw align: graph references (.gg/.sg) are not "
                         "ported yet (ROADMAP queue 1, item 5: graph engine)")
    for flag, on in (("--mesh", args.mesh), ("--multihost", args.multihost),
                     ("--index-sharding prefix",
                      args.index_sharding == "prefix")):
        if on:
            raise SystemExit(f"gsw align: {flag} is not ported yet (ROADMAP "
                             "queue 1, item 7: multi-device paths)")


def align_cmd(args) -> None:
    """Linear .fa reference -> SAM through a three-stage pipeline: batch
    i+1's host seeding (main thread) overlaps batch i's device work
    (launched without waiting) and batch i-1's SAM assembly (worker
    thread); writes drain in order on the main thread."""
    _refuse_unported(args)
    if len(args.files) not in (2, 3):
        raise SystemExit("gsw align: want ref.fa R1.fq [R2.fq]")
    records = fasta.read(args.files[0])
    al = ReadAligner(records, index_mode=args.index_mode,
                     index_step=args.index_step, device=args.device)
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
                                      "to a linear reference (SAM)")
    al.add_argument("files", nargs="+", help="ref.fa R1.fastq [R2.fastq]")
    al.add_argument("-o", "--out", default="/dev/stdout")
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
                    help="where the banded DP runs; cpu runs the kernels' "
                         "plain PyTorch versions")
    al.add_argument("--index-sharding", default="replicated",
                    choices=["replicated", "prefix"],
                    help="prefix is not ported yet")
    al.add_argument("--mesh", action="store_true", help="not ported yet")
    al.add_argument("--multihost", action="store_true",
                    help="not ported yet")
    a = p.parse_args(argv)
    align_cmd(a)


if __name__ == "__main__":
    main()
