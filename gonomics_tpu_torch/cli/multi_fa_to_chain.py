"""multiFaToChain: a pairwise multiFa alignment written as one UCSC
chain; a copy of ``gonomics_tpu/cli/multi_fa_to_chain.py`` (126 lines).

    gonomics-torch multiFaToChain [-swapTandQ] [-querySeqName q] in.fa
        tName qName out.chain

The chain's score is 100 and its id 1. A column's state (aligned, gap in
the target, gap in the query, or a double gap that is skipped) follows
``_query_state``; the last block's unaligned bases come off t_end and
q_end. ``-querySeqName`` puts that record in place of the second.
"""

from __future__ import annotations

import argparse

from .. import dna
from ..io import fasta as fastaio
from ..io import formats

IN_ALN, IN_T_GAP, IN_Q_GAP = 0, 1, 2


def _is_base(code: int) -> bool:
    """A, C, G, T or N in either case (multiFaToChain.go:165)."""
    return code in (dna.A, dna.C, dna.G, dna.T,
                    dna.LOWER_A, dna.LOWER_C, dna.LOWER_G, dna.LOWER_T,
                    dna.N, dna.LOWER_N)


def _query_state(t_code: int, q_code: int) -> tuple[int, bool]:
    """The state at one column, and True for a double gap
    (multiFaToChain.go:164-186)."""
    if _is_base(t_code):
        if _is_base(q_code):
            return IN_ALN, False
        if q_code == dna.GAP:
            return IN_Q_GAP, False
        raise ValueError("unrecognized dna base in the query sequence")
    if t_code == dna.GAP:
        if _is_base(q_code):
            return IN_T_GAP, False
        if q_code == dna.GAP:
            return IN_ALN, True
    raise ValueError("unrecognized dna base in the reference sequence")


def multi_fa_to_chain(in_file: str, t_name: str, q_name: str, out_file: str,
                      swap_t_and_q: bool = False,
                      query_seq_name: str = "") -> None:
    """cmd/multiFaToChain/multiFaToChain.go:33-150."""
    records = fastaio.read(in_file)
    if query_seq_name:
        idx = fastaio.find_sequence_index(records, query_seq_name)
        records[1] = records[idx]
    records = records[:2]
    if len(records[0].seq) != len(records[1].seq):
        raise ValueError("both sequences must be of the same alignment "
                         "length")
    if len(records[0].seq) < 1:
        raise ValueError("multiFaToChain expects non-empty DNA sequences")
    if swap_t_and_q:
        records[0], records[1] = records[1], records[0]

    degapped = fastaio.remove_gaps([fastaio.copy(r) for r in records])
    alignment: list[formats.BaseStats] = []
    prev_state, _ = _query_state(int(records[0].seq[0]),
                                 int(records[1].seq[0]))
    cur = formats.BaseStats(size=0, t_bases=0, q_bases=0)

    for t_code, q_code in zip(records[0].seq.tolist(),
                              records[1].seq.tolist()):
        state, double_gap = _query_state(t_code, q_code)
        if double_gap:
            continue
        if prev_state == state:
            if state == IN_ALN:
                cur.size += 1
            elif state == IN_T_GAP:
                cur.q_bases += 1
            else:
                cur.t_bases += 1
        else:
            if prev_state == IN_ALN:
                if state == IN_Q_GAP:
                    cur.t_bases += 1
                else:
                    cur.q_bases += 1
                prev_state = state
            else:  # leaving a gap state
                if state == IN_ALN:
                    alignment.append(cur)
                    cur = formats.BaseStats(size=1, t_bases=0, q_bases=0)
                    prev_state = IN_ALN
                elif prev_state == IN_T_GAP and state == IN_Q_GAP:
                    prev_state = IN_Q_GAP
                    cur.t_bases += 1
                else:  # Q gap -> T gap
                    prev_state = IN_T_GAP
                    cur.q_bases += 1
    alignment.append(cur)

    t_end = len(degapped[0].seq)
    q_end = len(degapped[1].seq)
    if alignment[-1].t_bases > 0:
        t_end -= alignment[-1].t_bases
    if alignment[-1].q_bases > 0:
        q_end -= alignment[-1].q_bases

    chain = formats.Chain(
        score=100, t_name=t_name, t_size=len(degapped[0].seq),
        t_strand=True, t_start=0, t_end=t_end,
        q_name=q_name, q_size=len(degapped[1].seq),
        q_strand=True, q_start=0, q_end=q_end,
        alignment=alignment, id=1)
    formats.write_chain(out_file, [chain])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaToChain")
    p.add_argument("-swapTandQ", action="store_true",
                   help="Swap the target and query in the output chain")
    p.add_argument("-querySeqName", default="",
                   help="Sequence in the multiFa to use as the query")
    p.add_argument("input")
    p.add_argument("tName")
    p.add_argument("qName")
    p.add_argument("output")
    a = p.parse_args(argv)
    multi_fa_to_chain(a.input, a.tName, a.qName, a.output,
                      swap_t_and_q=a.swapTandQ,
                      query_seq_name=a.querySeqName)


if __name__ == "__main__":
    main()
