"""Terminal genome-browser views of multiFa and pFasta alignments: a
copy of ``gonomics_tpu/browser.py`` (183 lines, whole), gonomics'
``browser/multiFa.go`` (``multi_fa_visualizer``, :26-82) and
``browser/pFa.go`` (the pFa views, :83-183).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from . import dna, fileio
from .io import fasta as fastaio
from .io import pfasta


@contextlib.contextmanager
def _out(filename: str):
    f = fileio.easy_create(filename)
    try:
        yield f
    finally:
        if f is not sys.stdout:
            f.close()


def multi_fa_visualizer(infile: str, outfile: str, start: int, end: int,
                        no_mask: bool, line_length: int,
                        end_of_alignment: bool) -> None:
    """browser.MultiFaVisualizer (multiFa.go:17-74): matched bases in
    non-reference rows print as dots; windows of lineLength columns."""
    if not start < end and not end_of_alignment:
        raise ValueError("Invalid arguments, start must be lower than end")
    records = fastaio.read(infile)
    if no_mask:
        for r in records:
            r.seq = dna.to_upper(r.seq)
    ref = records[0].seq
    for rec in records[1:]:
        rec.seq = np.where(rec.seq == ref, np.int8(dna.DOT), rec.seq)
    long = max(len(r.name) for r in records)

    # alignment column of the start-th reference base (multiFa.go:35-42)
    ref_counter = start_counter = 0
    t = 0
    while ref_counter < start:
        start_counter += 1
        if t == len(ref):
            raise ValueError("Ran out of chromosome")
        if ref[t] != dna.GAP:
            ref_counter += 1
        t += 1
    chrom_start = ref_counter

    with _out(outfile) as out:
        # header printed before the end scan, so refCounter == start
        # (multiFa.go:48)
        out.write(f"Start: {start}. refCounter: {ref_counter}. "
                  f"alignCounter: {start_counter}\n")
        if end_of_alignment:
            end_counter = len(ref)
        else:
            ref_counter = 0
            end_counter = 0
            n = 0
            while ref_counter < end:
                end_counter += 1
                if n == len(ref):
                    raise ValueError("Ran off the chromosome")
                if ref[n] != dna.GAP:
                    ref_counter += 1
                n += 1
        for k in range(start_counter, end_counter, line_length):
            out.write(f"Position: {chrom_start}\n")
            stop = min(end_counter, k + line_length)
            for rec in records:
                out.write(f"|{rec.name:<{long}}| "
                          f"{dna.to_string(rec.seq[k:stop])}\n")
            out.write("\n\n")
            gaps = int((ref[k:stop] == dna.GAP).sum())
            chrom_start = chrom_start + line_length - gaps


def _fmt_row(vals: np.ndarray, sig_figs: int, decimal_places: int) -> str:
    if sig_figs == 0:
        return "".join(f"\t{float(v):.{decimal_places}f}" for v in vals)
    return "".join(f"\t{float(v):.{sig_figs - 1}e}" for v in vals)


def _print_set(out, record: pfasta.PFasta, set_idx: int, n: int,
               line_length: int, start: int, sig_figs: int,
               decimal_places: int) -> None:
    """printOneSetLines (pFa.go:115): one Position block of 4 base rows."""
    rec_idx = set_idx * line_length + start
    out.write(f"Position: {rec_idx}\n")
    block = record.seq[rec_idx:rec_idx + n]
    long = len(record.name)
    for col, base in enumerate("ACGT"):
        name = record.name if base == "A" else ""
        out.write(f">{name:<{long}}\t|\t{base}\t|"
                  f"{_fmt_row(block[:, col], sig_figs, decimal_places)}\n")


def _select_record(records: list[pfasta.PFasta],
                   seq_name: str) -> pfasta.PFasta:
    if not records:
        raise ValueError("Error: User provided empty pfasta file.")
    if seq_name == "":
        if len(records) > 1:
            raise ValueError("Error: User must specify sequence name for "
                             "pFasta file with more than 1 sequence.")
        return records[0]
    for rec in records:
        if rec.name == seq_name:
            return rec
    raise ValueError("Error: User specified sequence not in input pfasta "
                     "file.")


def pfa_visualizer(infile: str, outfile: str, start: int, end: int,
                   start_of_alignment: bool, end_of_alignment: bool,
                   sig_figs: int, decimal_places: int, line_length: int,
                   seq_name: str) -> None:
    """browser.PFaVisualizer (pFa.go:17-92)."""
    if not start_of_alignment:
        if not end_of_alignment and not start < end:
            raise ValueError("Error: Invalid arguments, start must be "
                             "lower than end")
        if start < 0:
            raise ValueError("Error: Invalid arguments, start must be "
                             "greater or equal to 0")
    records = pfasta.read(infile)
    if start_of_alignment:
        start = 0
    rec = _select_record(records, seq_name)
    if end_of_alignment:
        end = len(rec.seq)
    formatting, num = (("Decimal Places", decimal_places) if sig_figs == 0
                       else ("SigFigs", sig_figs))
    with _out(outfile) as out:
        out.write(f"Start: {start}. End: {end}. {formatting}: {num}.")
        if end == -1:
            end = len(rec.seq)
        full_sets = (end - start) // line_length
        for set_idx in range(full_sets):
            out.write("\n")
            _print_set(out, rec, set_idx, line_length, line_length, start,
                       sig_figs, decimal_places)
        out.write("\n")
        _print_set(out, rec, full_sets, (end - start) % line_length,
                   line_length, start, sig_figs, decimal_places)


def pfa_visualizer_tsv(infile: str, outfile: str, start: int, end: int,
                       start_of_alignment: bool, end_of_alignment: bool,
                       sig_figs: int, decimal_places: int, line_length: int,
                       seq_name: str) -> None:
    """browser.PFaVisualizerTsv (pFa.go:174): R-ready long format. Note
    the reference's single-record branch widens end by one position
    (pFa.go:206) — replicated."""
    if not start_of_alignment:
        if not end_of_alignment and not start < end:
            raise ValueError("Error: Invalid arguments, start must be "
                             "lower than end")
        if start < 0:
            raise ValueError("Error: Invalid arguments, start must be "
                             "greater or equal to 0")
    records = pfasta.read(infile)
    if start_of_alignment:
        start = 0
    rec = _select_record(records, seq_name)
    if end_of_alignment:
        end = len(rec.seq)
    elif seq_name == "":
        end += 1
    with _out(outfile) as out:
        out.write("Position\tBase\tProbability\n")
        for idx in range(start, end):
            for col, base in enumerate("ACGT"):
                v = float(rec.seq[idx, col])
                if sig_figs == 0:
                    out.write(f"{idx}\t{base}\t{v:.{decimal_places}f}\n")
                else:
                    out.write(f"{idx}\t{base}\t{v:.{sig_figs - 1}e}\n")
