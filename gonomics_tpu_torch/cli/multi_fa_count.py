"""multiFaCount: the columns of a multiFa where one, both of two, or any
of three records hold a base; a copy of
``gonomics_tpu/cli/multi_fa_count.py`` (52 lines).

    gonomics-torch multiFaCount queryName in.fa out.txt [-both
        -secondQueryName s | -either -secondQueryName s -thirdQueryName t]

A base counts as present only if it is an upper-case A, C, G or T;
lower case and N do not.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import fasta as fastaio


def multi_fa_count(in_file: str, out_file: str, query: str, *,
                   both: bool = False, either: bool = False,
                   second: str = "", third: str = "") -> None:
    aln = fastaio.read(in_file)
    if both and either:
        raise SystemExit("both and either modes were both activated, but "
                         "they are currently mutually exclusive")
    with fileio.easy_create(out_file) as out:
        if not both and not either:
            n = fastaio.scan_present_base(aln, query)
            out.write("#querySequenceName\tpresentBaseCount\n")
            out.write(f"{query}\t{n}\n")
        elif both:
            n = fastaio.scan_present_base_both(aln, query, second)
            out.write("#firstQuerySequenceName\tsecondQuerySequenceName\t"
                      "bothPresentBaseCount\n")
            out.write(f"{query}\t{second}\t{n}\n")
        else:
            n = fastaio.scan_present_base_either(aln, query, second, third)
            out.write("#firstQuerySequenceName\tsecondQuerySequenceName\t"
                      "thirdQuerySequenceName\teitherPresentBaseCount\n")
            out.write(f"{query}\t{second}\t{third}\t{n}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaCount")
    p.add_argument("queryName")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-both", action="store_true")
    p.add_argument("-either", action="store_true")
    p.add_argument("-secondQueryName", default="")
    p.add_argument("-thirdQueryName", default="")
    a = p.parse_args(argv)
    multi_fa_count(a.input, a.output, a.queryName, both=a.both,
                   either=a.either, second=a.secondQueryName,
                   third=a.thirdQueryName)


if __name__ == "__main__":
    main()
