"""Terminal views of a pFasta record: the pFa part of
``gonomics_tpu/browser.py`` (:1-25 and :83-183), gonomics'
``browser/pFa.go``. ``multi_fa_visualizer`` (:26-82, browser/multiFa.go)
comes with multFaVisualizer in a later slice.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np

from . import fileio
from .io import pfasta


@contextlib.contextmanager
def _out(filename: str):
    f = fileio.easy_create(filename)
    try:
        yield f
    finally:
        if f is not sys.stdout:
            f.close()


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
