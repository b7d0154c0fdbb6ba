"""pileup on the PyTorch port: the whole of
``gonomics_tpu/cli/pileup_cmd.py``, counted on the host as the JAX tool
counts.

    python -m gonomics_tpu_torch.cli.pileup_cmd in.sam|in.bam [-o out] \
        [-minDP N]

Output: #Chr Pos A C G T N DEL INS columns, insertions as seq:count.
"""

from __future__ import annotations

import argparse

from .. import dna, fileio
from ..io import sam as samio
from ..pileup import Pile, pileup


def _fmt(pile: Pile, header: samio.Header) -> str:
    def tot(b: int) -> int:
        return int(pile.count_f[b] + pile.count_r[b])

    s = (f"{header.chroms[pile.ref_idx].name}\t{pile.pos}\t{tot(dna.A)}\t"
         f"{tot(dna.C)}\t{tot(dna.G)}\t{tot(dna.T)}\t{tot(dna.N)}\t"
         f"{tot(dna.GAP)}")
    for seq in sorted(set(pile.ins_count_f) | set(pile.ins_count_r)):
        n = pile.ins_count_f.get(seq, 0) + pile.ins_count_r.get(seq, 0)
        s += f"\t{seq}:{n}"
    return s


def pileup_cmd(infile: str, outfile: str, min_dp: int = 0) -> None:
    header, reads = samio.read(infile)
    filters = None
    if min_dp > 0:
        def depth_ok(p: Pile) -> bool:
            count = int(p.count_f.sum() + p.count_r.sum())
            count += sum(p.ins_count_f.values()) + sum(p.ins_count_r.values())
            return count >= min_dp
        filters = [depth_ok]
    piles = pileup(reads, header, None, filters)
    with fileio.easy_create(outfile) as out:
        out.write("#Chr\tPos\tA\tC\tG\tT\tN\tDEL\tINS\n")
        for p in piles:
            out.write(_fmt(p, header) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="pileup",
                                description="Count bases from sequencing data")
    p.add_argument("input")
    p.add_argument("-o", default="stdout")
    p.add_argument("-minDP", type=int, default=0)
    a = p.parse_args(argv)
    pileup_cmd(a.input, "-" if a.o == "stdout" else a.o, a.minDP)


if __name__ == "__main__":
    main()
