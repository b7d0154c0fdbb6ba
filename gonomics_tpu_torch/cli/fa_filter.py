"""faFilter: the records of a FASTA file kept by name, size and GC
content, cut to a range, a copy of ``gonomics_tpu/cli/fa_filter.py``
(103 lines), its flags and defaults unchanged.

    gonomics-torch faFilter in.fa out.fa [-name n] [-notName n]
        [-nameContains s] [-refPositions] [-start 0] [-end -1]
        [-minSize 0] [-maxGC 100] [-minGC 0] [-finalNBases n]
        [-cutFinalNBases n] [-appendBefore seq|x.fa] [-appendAfter seq|x.fa]

``gc_content`` (gonomics' ``dna.GCContent``) is what ``gcContent``
imports. A record with no A, C, G or T has a GC content of NaN, which
passes every ``-minGC`` and ``-maxGC`` (fa_filter.py:14-19, :45-46).
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import fasta as fastaio


def gc_content(seq: np.ndarray) -> float:
    """dna.GCContent (examine.go:59): percent GC over ACGT (both cases)."""
    s = dna.to_upper(np.asarray(seq))
    acgt = (s <= dna.T).sum()
    gc = ((s == dna.C) | (s == dna.G)).sum()
    return float(gc) * 100 / float(acgt) if acgt else float("nan")


def fa_filter(in_file: str, out_file: str, *, name: str = "",
              not_name: str = "", name_contains: str = "",
              ref_positions: bool = False, start: int = 0, end: int = -1,
              min_size: int = 0, max_gc: float = 100.0, min_gc: float = 0.0,
              final_n_bases: int = -1, cut_final_n_bases: int = -1,
              append_before: str = "", append_after: str = "") -> None:
    records = fastaio.read(in_file)
    if start > end and end != -1:
        raise SystemExit("End must be larger than Start.")
    if ref_positions:
        start = fastaio.ref_pos_to_aln_pos(records[0], start)
        end = fastaio.ref_pos_to_aln_pos(records[0], end)

    out: list[fastaio.Fasta] = []
    for rec in records:
        if name and rec.name != name:
            continue
        if not_name and rec.name == not_name:
            continue
        if name_contains and name_contains not in rec.name:
            continue
        if len(rec.seq) < min_size:
            continue
        gc = gc_content(rec.seq)
        if gc > max_gc or gc < min_gc:
            continue
        if final_n_bases > 0:
            length = max(len(rec.seq), final_n_bases)
            rec.seq = rec.seq[length - final_n_bases:]
        elif cut_final_n_bases > 0:
            if cut_final_n_bases >= len(rec.seq):
                continue
            rec.seq = rec.seq[:len(rec.seq) - cut_final_n_bases]
        else:
            rec.seq = rec.seq[start:] if end == -1 else rec.seq[start:end]
        out.append(rec)

    if append_before or append_after:
        def load(x):
            if x.endswith(".fa"):
                rs = fastaio.read(x)
                if len(rs) != 1:
                    raise SystemExit("ERROR: Fasta file for appending must "
                                     "only have 1 fasta record")
                return rs[0].seq
            return dna.from_string(x) if x else np.zeros(0, np.int8)

        before = load(append_before)
        after = load(append_after)
        for rec in out:
            rec.seq = np.concatenate([before, rec.seq, after])
    fastaio.write(out_file, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-name", default="")
    p.add_argument("-notName", default="")
    p.add_argument("-nameContains", default="")
    p.add_argument("-refPositions", action="store_true")
    p.add_argument("-start", type=int, default=0)
    p.add_argument("-end", type=int, default=-1)
    p.add_argument("-minSize", type=int, default=0)
    p.add_argument("-maxGC", type=float, default=100.0)
    p.add_argument("-minGC", type=float, default=0.0)
    p.add_argument("-finalNBases", type=int, default=-1)
    p.add_argument("-cutFinalNBases", type=int, default=-1)
    p.add_argument("-appendBefore", default="")
    p.add_argument("-appendAfter", default="")
    a = p.parse_args(argv)
    fa_filter(a.input, a.output, name=a.name, not_name=a.notName,
              name_contains=a.nameContains, ref_positions=a.refPositions,
              start=a.start, end=a.end, min_size=a.minSize, max_gc=a.maxGC,
              min_gc=a.minGC, final_n_bases=a.finalNBases,
              cut_final_n_bases=a.cutFinalNBases,
              append_before=a.appendBefore, append_after=a.appendAfter)


if __name__ == "__main__":
    main()
