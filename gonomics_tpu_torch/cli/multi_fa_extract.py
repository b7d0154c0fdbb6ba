"""multiFaExtract: the columns of a multiFa between two positions of its
first record; a copy of ``gonomics_tpu/cli/multi_fa_extract.py`` (55
lines).

    gonomics-torch multiFaExtract in.fa out.fa start end [-removeGaps]
    gonomics-torch multiFaExtract in.fa -bed regions.bed [-removeGaps]

With ``-bed`` each region goes to ``chrom.start.end.fa`` in the current
directory: the CLI never sets ``out_dir``.
"""

from __future__ import annotations

import argparse

from ..io import bed as bedio
from ..io import fasta as fastaio


def _extract_multi(records, start: int, end: int):
    a = fastaio.ref_pos_to_aln_pos(records[0], start)
    b = fastaio.ref_pos_to_aln_pos(records[0], end)
    return [fastaio.extract(r, a, b, r.name) for r in records]


def multi_fa_extract(in_file: str, out_file: str = "", *, start: int = -1,
                     end: int = -1, bed_file: str = "",
                     remove_gaps: bool = False, out_dir: str = "") -> None:
    records = fastaio.read(in_file)
    if not bed_file:
        if not start < end:
            raise SystemExit("Invalid arguments, start must be lower "
                             "than end")
        ans = _extract_multi(records, start, end)
        if remove_gaps:
            ans = fastaio.remove_gaps(ans)
        fastaio.write(out_file, ans)
        return
    prefix = out_dir + "/" if out_dir else ""
    for b in bedio.read(bed_file):
        ans = _extract_multi(records, b.chrom_start, b.chrom_end)
        if remove_gaps:
            ans = fastaio.remove_gaps(ans)
        fastaio.write(f"{prefix}{b.chrom}.{b.chrom_start}.{b.chrom_end}.fa",
                      ans)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaExtract")
    p.add_argument("args", nargs="*")
    p.add_argument("-removeGaps", action="store_true")
    p.add_argument("-bed", default="")
    a = p.parse_args(argv)
    if a.bed:
        multi_fa_extract(a.args[0], bed_file=a.bed,
                         remove_gaps=a.removeGaps)
    else:
        multi_fa_extract(a.args[0], a.args[1], start=int(a.args[2]),
                         end=int(a.args[3]), remove_gaps=a.removeGaps)


if __name__ == "__main__":
    main()
