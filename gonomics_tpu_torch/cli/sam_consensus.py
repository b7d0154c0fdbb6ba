"""samConsensus on the PyTorch port: the whole of
``gonomics_tpu/cli/sam_consensus.py``, on the host as the JAX tool runs.

    python -m gonomics_tpu_torch.cli.sam_consensus in.sam|in.bam ref.fa \
        out.fa [-substitutionsOnly] [-multiFaDir DIR] \
        [-insertionThreshold 0.1] [-tName Target] [-qName Query]

Uncovered positions keep the reference, lower-cased; covered positions
take the pile consensus (base, insertion or deletion). With -multiFaDir,
a two-record alignment of the target (upper-cased) and the consensus a
chromosome goes to DIR/<chrom>.fa.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..consensus import BASE, INSERTION, UNDEFINED, pile_consensus
from ..io import fasta, sam as samio
from ..pileup import pileup


def sam_consensus(sam_file: str, ref_file: str, out_file: str, *,
                  multi_fa_dir: str = "", substitutions_only: bool = False,
                  insertion_threshold: float = 0.1, t_name: str = "Target",
                  q_name: str = "Query") -> None:
    if not 0 <= insertion_threshold <= 1:
        raise SystemExit("InsertionThreshold option must be a value between "
                         "0 and 1.")
    ref = fasta.read(ref_file)
    ref_map = {r.name: dna.to_lower(r.seq) for r in ref}

    header, reads = samio.read(sam_file)
    piles = pileup(reads, header, None, None)

    answer = {r.name: [] for r in ref}  # name -> list of base chunks
    multi = None  # [target chunks, query chunks]
    cur_chrom = None
    ref_pos = 0
    skip = 0

    def flush_chrom():
        nonlocal ref_pos
        seq = ref_map[cur_chrom]
        tail = seq[ref_pos:]
        answer[cur_chrom].append(tail)
        if multi is not None:
            multi[0].append(dna.to_upper(tail))
            multi[1].append(tail)
            fasta.write(f"{multi_fa_dir}/{cur_chrom}.fa", [
                fasta.Fasta(t_name, np.concatenate(multi[0]) if multi[0]
                            else np.zeros(0, np.int8)),
                fasta.Fasta(q_name, np.concatenate(multi[1]) if multi[1]
                            else np.zeros(0, np.int8)),
            ])
        ref_pos = len(seq)

    for p in piles:
        chrom = header.chroms[p.ref_idx].name
        if skip > 0:  # inside a called deletion
            skip -= 1
            if multi is not None:
                multi[0].append(dna.to_upper(ref_map[cur_chrom][ref_pos:ref_pos + 1]))
                multi[1].append(dna.all_gaps(1))
            ref_pos += 1
            continue
        if cur_chrom is None:
            cur_chrom = chrom
            ref_pos = 0
            if multi_fa_dir:
                multi = [[], []]
        if chrom != cur_chrom:
            flush_chrom()
            cur_chrom = chrom
            ref_pos = 0
            if multi_fa_dir:
                multi = [[], []]
        # catch up over uncovered positions
        if ref_pos < p.pos - 1:
            span = ref_map[cur_chrom][ref_pos:p.pos - 1]
            answer[cur_chrom].append(span)
            if multi is not None:
                multi[0].append(dna.to_upper(span))
                multi[1].append(span)
            ref_pos = p.pos - 1

        cons = pile_consensus(p, substitutions_only, insertion_threshold)
        if cons.type == UNDEFINED:
            b = ref_map[cur_chrom][ref_pos:ref_pos + 1]
            answer[cur_chrom].append(b)
            if multi is not None:
                multi[0].append(dna.to_upper(b))
                multi[1].append(b)
            ref_pos += 1
        elif cons.type == BASE:
            answer[cur_chrom].append(np.array([cons.base], np.int8))
            if multi is not None:
                multi[0].append(dna.to_upper(ref_map[cur_chrom][ref_pos:ref_pos + 1]))
                multi[1].append(np.array([cons.base], np.int8))
            ref_pos += 1
        elif cons.type == INSERTION:
            answer[cur_chrom].append(np.array([cons.base], np.int8))
            answer[cur_chrom].append(cons.insertion)
            if multi is not None:
                multi[0].append(dna.to_upper(ref_map[cur_chrom][ref_pos:ref_pos + 1]))
                multi[1].append(np.array([cons.base], np.int8))
                multi[0].append(dna.all_gaps(len(cons.insertion)))
                multi[1].append(cons.insertion)
            ref_pos += 1
        else:  # DELETION: nothing written at this position
            skip = cons.deletion - 1
            if multi is not None:
                multi[0].append(dna.to_upper(ref_map[cur_chrom][ref_pos:ref_pos + 1]))
                multi[1].append(dna.all_gaps(1))
            ref_pos += 1

    if cur_chrom is not None:
        flush_chrom()

    out_records = []
    for r in ref:
        chunks = answer[r.name]
        seq = np.concatenate(chunks) if chunks else np.zeros(0, np.int8)
        out_records.append(fasta.Fasta(r.name, seq))
    fasta.write(out_file, out_records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="samConsensus",
        description="Generates a fasta file from a sam over a reference "
                    "sequence. Uncovered sequences are converted to "
                    "lowercase reference sequences.")
    p.add_argument("sam")
    p.add_argument("ref")
    p.add_argument("out")
    p.add_argument("-substitutionsOnly", action="store_true")
    p.add_argument("-multiFaDir", default="")
    p.add_argument("-insertionThreshold", type=float, default=0.1)
    p.add_argument("-tName", default="Target")
    p.add_argument("-qName", default="Query")
    a = p.parse_args(argv)
    sam_consensus(a.sam, a.ref, a.out, multi_fa_dir=a.multiFaDir,
                  substitutions_only=a.substitutionsOnly,
                  insertion_threshold=a.insertionThreshold,
                  t_name=a.tName, q_name=a.qName)


if __name__ == "__main__":
    main()
