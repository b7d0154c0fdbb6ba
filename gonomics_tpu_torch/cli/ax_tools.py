"""axTools: stats, filters, consensus and swap of axt alignments; a copy
of ``gonomics_tpu/cli/ax_tools.py`` (113 lines, whole), gonomics'
``cmd/axTools``, its flags, defaults and error texts unchanged.

    gonomics-torch axTools --gap in.axt out.axt
    gonomics-torch axTools --fasta target.fa in.axt out.fa
    gonomics-torch axTools --swap --tLen t.sizes --qLen q.sizes in.axt
        out.axt
    gonomics-torch axTools --minScore 100 in.axt out.axt
    gonomics-torch axTools --stats --bedfile stats.txt in.axt regions.bed

The first operation set runs, in this order: --gap, --fasta (by its
extension), --swap, --minScore, --stats. --gap keeps the records whose
target holds an upper-case N and whose query holds none; --fasta exits
on a record whose target row holds a gap. --stats keeps the reference's
wiring (axTools.go:66 against its signature at :77): the positional
output is read as the bed of regions, and --bedfile names the stats
file. ``axt_stats`` itself takes (input, bed, output), as the
reference's own test calls it.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio, interval
from ..io import bed as bedio
from ..io import chrom_info
from ..io import fasta as fastaio
from ..io import formats


def axt_stats(in_axt: str, bed_file: str, out_stats: str) -> None:
    records = formats.read_axt(in_axt)
    tree = None
    if bed_file:
        tree = interval.IntervalIndex(bedio.read(bed_file))
    with fileio.easy_create(out_stats) as out:
        out.write("length\tpercentIdentity\n")
        for a in records:
            if tree is not None and not tree.query(a, "any"):
                continue
            length = a.chrom_end - a.chrom_start
            pid = formats.axt_percent_identity_in_interval(
                a, a.chrom_start, a.chrom_end)
            out.write(f"{length}\t{pid:.2f}\n")


def filter_axt(in_file: str, out_file: str) -> None:
    """-gap: keep records whose target has Ns but query does not."""
    kept = [a for a in formats.read_axt(in_file)
            if dna.count_base(a.r_seq, dna.N) != 0
            and dna.count_base(a.q_seq, dna.N) == 0]
    formats.write_axt(out_file, kept)


def filter_axt_score(in_file: str, out_file: str, min_score: int) -> None:
    kept = [a for a in formats.read_axt(in_file) if a.score >= min_score]
    formats.write_axt(out_file, kept)


def axt_to_fa(in_file: str, out_file: str, target_fa: str) -> None:
    """-fasta: consensus per record — query bases patch target Ns
    (consensus logic, axTools.go:axtSeq)."""
    fa_map = fastaio.read_to_map(target_fa)
    with fileio.easy_create(out_file) as out:
        for a in formats.read_axt(in_file):
            ref = fa_map[a.r_name]
            seq = list(ref[:a.r_start - 1])
            for i in range(len(a.r_seq)):
                if a.r_seq[i] == dna.N and a.q_seq[i] != dna.N:
                    seq.append(a.q_seq[i])
                else:
                    seq.append(a.r_seq[i])
            seq.extend(ref[a.r_end:])
            if len(seq) != len(ref):
                raise SystemExit("Error: Sequence length is not the same...")
            fastaio.write_fasta(out, fastaio.Fasta(a.r_name,
                                                   np.array(seq, np.int8)),
                                50)


def query_swap_all(in_file: str, out_file: str, target_len: str,
                   query_len: str) -> None:
    t_info = chrom_info.read_to_map(target_len)
    q_info = chrom_info.read_to_map(query_len)
    records = formats.read_axt(in_file)
    for a in records:
        formats.swap_axt(a, t_info[a.r_name].size, q_info[a.q_name].size)
    formats.write_axt(out_file, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="axTools")
    p.add_argument("--gap", action="store_true")
    p.add_argument("--swap", action="store_true")
    p.add_argument("--tLen", default="")
    p.add_argument("--qLen", default="")
    p.add_argument("--fasta", default="")
    p.add_argument("--minScore", type=int, default=0)
    p.add_argument("--stats", action="store_true")
    p.add_argument("--bedfile", default="")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    if a.bedfile and not a.stats:
        raise SystemExit("ERROR: -bedfile must be used with -stats.")
    if a.gap:
        filter_axt(a.input, a.output)
    elif a.fasta.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        axt_to_fa(a.input, a.output, a.fasta)
    elif a.swap:
        query_swap_all(a.input, a.output, a.tLen, a.qLen)
    elif a.minScore != 0:
        filter_axt_score(a.input, a.output, a.minScore)
    elif a.stats:
        # reference arg wiring (axTools.go:66): output↔bedfile swapped
        axt_stats(a.input, a.output, a.bedfile)
    else:
        raise SystemExit("no operation selected")


if __name__ == "__main__":
    main()
