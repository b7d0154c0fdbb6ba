"""pFaTools: manipulate pFasta files; a copy of
``gonomics_tpu/cli/pfa_tools.py`` (173 lines, whole), gonomics'
``cmd/pFaTools``.

Subcommands: entropyTrack, extract, extractBed, sample, visualize,
faToPfa, vcfToPfa. ``sample`` draws from numpy's PCG64 ``default_rng``
under ``-setseed``, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import browser, fileio, pdna
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io import pfasta
from ..io import wig as wigio

MAX_FLOAT64 = sys.float_info.max


def entropy_track(in_file: str, out_file: str,
                  default_value: float = MAX_FLOAT64) -> None:
    """pFaEntropyTrack (cmd/pFaTools/entropyTrack.go:58): per-position
    Shannon entropy as a fixedStep wig."""
    records = pfasta.read(in_file)
    answer = {}
    for rec in records:
        # the reference's Wig literal leaves Span at Go's zero value, so
        # headers carry span=0 (entropyTrack.go:64, wig.go:151)
        answer[rec.name] = wigio.Wig(
            step_type="fixedStep", chrom=rec.name, start=1, step=1, span=0,
            default_value=default_value, values=pdna.entropy(rec.seq))
    wigio.write(out_file, answer)


def pfa_extract(in_file: str, chrom: str, start: int, end: int,
                out_file: str, out_name: str = "") -> None:
    """pFaExtract (cmd/pFaTools/extract.go:71)."""
    records = [pfasta.extract(pfasta.read(in_file), start, end, out_name,
                              chrom, False)]
    pfasta.write(out_file, records)


def pfa_extract_bed(in_file: str, region_file: str, out_file: str,
                    take_coords: bool = False) -> None:
    """pFaExtractBed (cmd/pFaTools/extractBed.go:61)."""
    records = pfasta.extract_bed(pfasta.read(in_file),
                                 bedio.read(region_file), take_coords)
    pfasta.write(out_file, records)


def pfa_sample(in_file: str, chrom: str, out_dir: str,
               num_samples: int = 1, set_seed: int = 0) -> None:
    """pFaSample (cmd/pFaTools/sample.go:68): writes
    outDir/sample_<i>.fa per draw. numpy Generator replaces Go's global
    rand (COVERAGE.md known parity limitation)."""
    rng = np.random.default_rng(set_seed)
    records = pfasta.read(in_file)
    for i in range(num_samples):
        out_name = f"{out_dir}/sample_{i}.fa"
        rec = pfasta.sample(records, chrom, rng)
        with fileio.easy_create(out_name) as out:
            fastaio.write_fasta(out, rec, 50)


def fa_to_pfa(in_file: str, out_file: str, start: int = 0, end: int = -1,
              chrom: str = "") -> None:
    """faToPfa (cmd/pFaTools/faToPfa.go:62)."""
    records = [pfasta.multi_fa_to_pfa(in_file, start, end, chrom)]
    pfasta.write(out_file, records)


def vcf_to_pfa(in_file: str, ref_file: str, out_file: str, start: int = 0,
               end: int = -1) -> None:
    """vcfToPfa (cmd/pFaTools/vcfToPfa.go:67)."""
    records = [pfasta.vcf_to_pfa(in_file, ref_file, start, end)]
    pfasta.write(out_file, records)


def _parse_start_end(start_arg: str, end_arg: str) -> tuple[int, int, bool,
                                                            bool]:
    start_of_aln = start_arg.upper() == "START"
    end_of_aln = end_arg.upper() == "END"
    start = 0 if start_of_aln else int(start_arg)
    end = -1 if end_of_aln else int(end_arg)
    return start, end, start_of_aln, end_of_aln


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(
            "Error: user must specify a pFaTools subcommand "
            "(entropyTrack/extract/extractBed/sample/visualize/faToPfa/"
            "vcfToPfa).")
    sub, rest = argv[0], argv[1:]
    if sub == "entropyTrack":
        p = argparse.ArgumentParser(prog="pFaTools entropyTrack")
        p.add_argument("-defaultValue", type=float, default=MAX_FLOAT64)
        p.add_argument("input")
        p.add_argument("output")
        a = p.parse_args(rest)
        entropy_track(a.input, a.output, a.defaultValue)
    elif sub == "extract":
        p = argparse.ArgumentParser(prog="pFaTools extract")
        p.add_argument("-outName", default="")
        p.add_argument("input")
        p.add_argument("chrom")
        p.add_argument("start", type=int)
        p.add_argument("end", type=int)
        p.add_argument("output")
        a = p.parse_args(rest)
        pfa_extract(a.input, a.chrom, a.start, a.end, a.output, a.outName)
    elif sub == "extractBed":
        p = argparse.ArgumentParser(prog="pFaTools extractBed")
        p.add_argument("-takeCoords", action="store_true")
        p.add_argument("input")
        p.add_argument("region")
        p.add_argument("output")
        a = p.parse_args(rest)
        pfa_extract_bed(a.input, a.region, a.output, a.takeCoords)
    elif sub == "sample":
        p = argparse.ArgumentParser(prog="pFaTools sample")
        p.add_argument("-numSamples", type=int, default=1)
        p.add_argument("-setseed", type=int, default=0)
        p.add_argument("input")
        p.add_argument("chrom")
        p.add_argument("outDir")
        a = p.parse_args(rest)
        pfa_sample(a.input, a.chrom, a.outDir, a.numSamples, a.setseed)
    elif sub == "visualize":
        p = argparse.ArgumentParser(prog="pFaTools visualize")
        p.add_argument("-sigFigs", type=int, default=0)
        p.add_argument("-decimal", type=int, default=5)
        p.add_argument("-lineLength", type=int, default=50)
        p.add_argument("-chrom", default="")
        p.add_argument("-tsvOut", action="store_true")
        p.add_argument("input")
        p.add_argument("start")
        p.add_argument("end")
        p.add_argument("output")
        a = p.parse_args(rest)
        start, end, s_aln, e_aln = _parse_start_end(a.start, a.end)
        fn = (browser.pfa_visualizer_tsv if a.tsvOut
              else browser.pfa_visualizer)
        fn(a.input, a.output, start, end, s_aln, e_aln, a.sigFigs,
           a.decimal, a.lineLength, a.chrom)
    elif sub == "faToPfa":
        p = argparse.ArgumentParser(prog="pFaTools faToPfa")
        p.add_argument("-start", type=int, default=0)
        p.add_argument("-end", type=int, default=-1)
        p.add_argument("-chrom", default="")
        p.add_argument("input")
        p.add_argument("output")
        a = p.parse_args(rest)
        fa_to_pfa(a.input, a.output, a.start, a.end, a.chrom)
    elif sub == "vcfToPfa":
        p = argparse.ArgumentParser(prog="pFaTools vcfToPfa")
        p.add_argument("-start", type=int, default=0)
        p.add_argument("-end", type=int, default=-1)
        p.add_argument("input")
        p.add_argument("ref")
        p.add_argument("output")
        a = p.parse_args(rest)
        vcf_to_pfa(a.input, a.ref, a.output, a.start, a.end)
    else:
        raise SystemExit(f"Error: unrecognized subcommand: {sub}.")


if __name__ == "__main__":
    main()
