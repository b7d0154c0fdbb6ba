"""fastqFormat: 10x single-cell paired reads renamed with their UMI and
barcode, both trimmed off the forward read; a copy of
``gonomics_tpu/cli/fastq_format.py`` (44 lines), its flags and defaults
unchanged.

    gonomics-torch fastqFormat -pairedEnd -singleCell r1.fq r2.fq o1.fq
        o2.fq [-barcodeLength 16] [-umiLength 12]

It exits unless both ``-pairedEnd`` and ``-singleCell`` are given. Each
name, cut at its first space, gains ``_UMI:<umi>_BX:<barcode>``.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import fastq as fastqio


def fastq_format(r1_in: str, r2_in: str, r1_out: str, r2_out: str,
                 barcode_length: int = 16, umi_length: int = 12) -> None:
    with fileio.easy_create(r1_out) as o1, \
            fileio.easy_create(r2_out) as o2:
        for fwd, rev in fastqio.read_pairs(r1_in, r2_in):
            new_fwd, new_rev, _, _ = fastqio.to_single_cell_pair(
                fwd, rev, barcode_length, umi_length)
            fastqio.write_to_handle(o1, new_fwd)
            fastqio.write_to_handle(o2, new_rev)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="fastqFormat")
    p.add_argument("args", nargs="*")
    p.add_argument("-pairedEnd", action="store_true")
    p.add_argument("-singleCell", action="store_true")
    p.add_argument("-barcodeLength", type=int, default=16)
    p.add_argument("-umiLength", type=int, default=12)
    a = p.parse_args(argv)
    if not a.pairedEnd:
        raise SystemExit("fastqFormat is still under development. "
                         "Currently, the only formatting options available "
                         "are for paired end reads. Select 'pairedEnd' "
                         "from options.")
    if not a.singleCell:
        raise SystemExit("fastqFormat is still under development. Select "
                         "'singleCell' from options.")
    fastq_format(a.args[0], a.args[1], a.args[2], a.args[3],
                 a.barcodeLength, a.umiLength)


if __name__ == "__main__":
    main()
