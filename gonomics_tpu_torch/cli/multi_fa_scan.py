"""multiFaScan: the N bases of one multiFa record as one-base bed
records in the first record's coordinates; a copy of
``gonomics_tpu/cli/multi_fa_scan.py`` (33 lines).

    gonomics-torch multiFaScan --queryName q [--chrom chrom] in.fa out.bed

Only upper-case N counts. The flags take two dashes; an empty or
unknown query name exits. Each record is named after the first record.
"""

from __future__ import annotations

import argparse

from ..io import bed as bedio
from ..io import fasta as fastaio


def multi_fa_scan(in_file: str, out_file: str, *, query_name: str = "",
                  chrom: str = "chrom") -> None:
    aln = fastaio.read(in_file)
    spans = fastaio.scan_n(aln, query_name)
    records = [bedio.Bed(chrom=chrom, chrom_start=s, chrom_end=e,
                         name=aln[0].name, fields_initialized=4)
               for s, e in spans]
    bedio.write(out_file, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaScan")
    p.add_argument("--queryName", default="")
    p.add_argument("--chrom", default="chrom")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    multi_fa_scan(a.input, a.output, query_name=a.queryName, chrom=a.chrom)


if __name__ == "__main__":
    main()
