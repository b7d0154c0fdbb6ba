"""fastqFilter: keep the FASTQ records, single or paired, that pass size,
name, cell-barcode and UMI tests and a random subset; a copy of
``gonomics_tpu/cli/fastq_filter.py`` (119 lines), its flags and defaults
unchanged.

    gonomics-torch fastqFilter in.fq out.fq [-subSet p] [-setSeed n]
        [-minSize n] [-maxSize n] [-retainNamesList f | -discardNamesList f]
    gonomics-torch fastqFilter -pairedEnd r1.fq r2.fq o1.fq o2.fq
        [-collapseUmi] [-keepCellsList f] [-barcodeLength 16]
        [-umiLength 12] ...

The draws come from ``np.random.default_rng`` seeded with ``-setSeed``,
unseeded at the default -1. Single-end, every record draws, before any
other test, even at ``-subSet 1``; paired-end, a pair draws only where
``-subSet`` < 1, after the size test. Paired, ``-retainNamesList`` keeps a pair if either
name is listed, and ``-collapseUmi`` keys on the (barcode, UMI) bytes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import dna, fileio
from ..io import fastq as fastqio


def fastq_filter(*, in_file: str = "", out_file: str = "",
                 r1_in: str = "", r2_in: str = "", r1_out: str = "",
                 r2_out: str = "", paired_end: bool = False,
                 subset: float = 1.0, set_seed: int = -1,
                 min_size: int = 0, max_size: int = sys.maxsize,
                 retain_names_list: str = "", discard_names_list: str = "",
                 keep_cells_list: str = "", collapse_umi: bool = False,
                 barcode_length: int = 16, umi_length: int = 12) -> None:
    if retain_names_list and discard_names_list:
        raise SystemExit("fastqFilter cannot accept arguments for both a "
                         "discard names list and retain names list "
                         "simultaneously.")
    rng = np.random.default_rng(None if set_seed < 0 else set_seed)
    names = set()
    if retain_names_list:
        names = set(fileio.read(retain_names_list))
    if discard_names_list:
        names = set(fileio.read(discard_names_list))
    cells = set(fileio.read(keep_cells_list)) if keep_cells_list else set()

    if paired_end:
        seen_umis: set[tuple] = set()
        kept: list[tuple[fastqio.Fastq, fastqio.Fastq]] = []
        for fwd, rev in fastqio.read_pairs(r1_in, r2_in):
            if (len(fwd.seq) < min_size or len(rev.seq) < min_size
                    or len(fwd.seq) > max_size or len(rev.seq) > max_size):
                continue
            if subset < 1 and rng.random() > subset:
                continue
            if retain_names_list and fwd.name not in names \
                    and rev.name not in names:
                continue
            if discard_names_list and (fwd.name in names
                                       or rev.name in names):
                continue
            if collapse_umi or keep_cells_list:
                _, _, bx, umi = fastqio.to_single_cell_pair(
                    fwd, rev, barcode_length, umi_length)
            if collapse_umi:
                key = (bx.tobytes(), umi.tobytes())
                if key in seen_umis:
                    continue
                seen_umis.add(key)
            if keep_cells_list and dna.to_string(bx) not in cells:
                continue
            kept.append((fwd, rev))
        fastqio.write_pairs(r1_out, r2_out, kept)
        return

    with fileio.easy_create(out_file) as out:
        for rec in fastqio.read(in_file):
            if rng.random() > subset:
                continue
            if len(rec.seq) < min_size or len(rec.seq) > max_size:
                continue
            if retain_names_list and rec.name not in names:
                continue
            if discard_names_list and rec.name in names:
                continue
            fastqio.write_to_handle(out, rec)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="fastqFilter")
    p.add_argument("args", nargs="*")
    p.add_argument("-pairedEnd", action="store_true")
    p.add_argument("-subSet", type=float, default=1.0)
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-minSize", type=int, default=0)
    p.add_argument("-maxSize", type=int, default=sys.maxsize)
    p.add_argument("-retainNamesList", default="")
    p.add_argument("-discardNamesList", default="")
    p.add_argument("-keepCellsList", default="")
    p.add_argument("-collapseUmi", action="store_true")
    p.add_argument("-barcodeLength", type=int, default=16)
    p.add_argument("-umiLength", type=int, default=12)
    a = p.parse_args(argv)
    if not 0 <= a.subSet <= 1:
        raise SystemExit("The subSet option must be between 0 and 1, "
                         f"received {a.subSet}.")
    if a.collapseUmi and not a.pairedEnd:
        raise SystemExit("To collapse UMIs from single-cell reads, select "
                         "pairedEnd AND collapseUmi.")
    if a.keepCellsList and not a.pairedEnd:
        raise SystemExit("keepCellsList must be used in paired end mode")
    kw = dict(subset=a.subSet, set_seed=a.setSeed, min_size=a.minSize,
              max_size=a.maxSize, retain_names_list=a.retainNamesList,
              discard_names_list=a.discardNamesList,
              keep_cells_list=a.keepCellsList, collapse_umi=a.collapseUmi,
              barcode_length=a.barcodeLength, umi_length=a.umiLength)
    if a.pairedEnd:
        fastq_filter(r1_in=a.args[0], r2_in=a.args[1], r1_out=a.args[2],
                     r2_out=a.args[3], paired_end=True, **kw)
    else:
        fastq_filter(in_file=a.args[0], out_file=a.args[1], **kw)


if __name__ == "__main__":
    main()
