"""multiFaSequenceSwap: a copy of one multiFa record with the bases of
another inside bed regions; a copy of
``gonomics_tpu/cli/multi_fa_sequence_swap.py`` (57 lines).

    gonomics-torch multiFaSequenceSwap in.fa regions.bed background
        foreground chromName out.fa

The regions are sorted and merged first, and those on other chroms
skipped. Reference positions are counted on the first record, not on
the background. The output holds every input record, then
``<background>.swapped``.
"""

from __future__ import annotations

import argparse

from ..io import bed as bedio
from ..io import fasta as fastaio


def multi_fa_sequence_swap(in_file: str, swap_regions_file: str,
                           background: str, foreground: str,
                           chrom_name: str, out_file: str) -> None:
    records = fastaio.read(in_file)
    regions = bedio.read(swap_regions_file)
    bedio.sort_by_coord(regions)
    regions = bedio.merge_high_mem(regions)
    bg = fastaio.find_sequence_index(records, background)
    fg = fastaio.find_sequence_index(records, foreground)
    answer = fastaio.copy(records[bg])
    fg_seq = records[fg].seq

    curr_ref = curr_aln = last_ref = last_aln = 0
    for region in regions:
        if region.chrom != chrom_name:
            continue
        if region.chrom_start < 0 or region.chrom_start >= region.chrom_end:
            raise SystemExit("Error: Invalid swap region.")
        if curr_ref > region.chrom_start:
            raise SystemExit("Something went wrong. Debug required.")
        while curr_ref < region.chrom_end:
            if curr_ref >= region.chrom_start:
                answer.seq[curr_aln] = fg_seq[curr_aln]
            curr_aln += 1
            curr_ref = fastaio.aln_pos_to_ref_pos_counter(
                records[0], curr_aln, last_ref, last_aln)
            last_ref, last_aln = curr_ref, curr_aln
    answer.name = f"{background}.swapped"
    fastaio.write(out_file, records + [answer])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaSequenceSwap")
    p.add_argument("input")
    p.add_argument("bed")
    p.add_argument("background")
    p.add_argument("foreground")
    p.add_argument("chromName")
    p.add_argument("output")
    a = p.parse_args(argv)
    multi_fa_sequence_swap(a.input, a.bed, a.background, a.foreground,
                           a.chromName, a.output)


if __name__ == "__main__":
    main()
