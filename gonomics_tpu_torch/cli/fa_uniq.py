"""faUniq: one record for each distinct sequence, in first-seen order,
its name joined by ``"; "`` to the names of its repeats, a copy of
``gonomics_tpu/cli/fa_uniq.py`` (34 lines).

    gonomics-torch faUniq in.fa out.fa
"""

from __future__ import annotations

import argparse

from .. import dna
from ..io import fasta as fastaio


def fa_uniq(in_file: str, out_file: str) -> None:
    all_seqs = fastaio.read(in_file)
    seen: dict[str, int] = {dna.to_string(all_seqs[0].seq): 0}
    unique = [all_seqs[0]]
    for rec in all_seqs[1:]:
        key = dna.to_string(rec.seq)
        if key not in seen:
            seen[key] = len(unique)
            unique.append(rec)
        else:
            unique[seen[key]].name += "; " + rec.name
    fastaio.write(out_file, unique)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="faUniq")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    fa_uniq(a.input, a.output)


if __name__ == "__main__":
    main()
