"""divergenceSpectrum: the six classes of single-base substitutions of a
VCF in each bed region; a copy of
``gonomics_tpu/cli/divergence_spectrum.py`` (51 lines).

    gonomics-torch divergenceSpectrum in.bed in.vcf out.bed

Each region is written with 13 fields, its six counts as annotations.
The classes follow the reference's code, not its comment: C>T/G>A (0)
and A>G/T>C (1) are the transitions; A>T/T>A (2), C>G/G>C (3), C>A/G>T
(4) and A>C/T>G (5) the transversions. Any overlapping record that is
not a single-base substitution ends the run: "Poorly formed VCF".
"""

from __future__ import annotations

import argparse

from .. import fileio, interval
from ..io import bed as bedio
from ..io import vcf as vcfio

_MUTATION_TYPE = {
    ("A", "C"): 5, ("A", "G"): 1, ("A", "T"): 2,
    ("C", "A"): 4, ("C", "G"): 3, ("C", "T"): 0,
    ("G", "A"): 0, ("G", "C"): 3, ("G", "T"): 4,
    ("T", "A"): 2, ("T", "C"): 1, ("T", "G"): 5,
}


def divergence_spectrum(in_bed: str, in_vcf: str, out_file: str) -> None:
    variants, _ = vcfio.read(in_vcf)
    tree = interval.IntervalIndex(list(variants))
    with fileio.easy_create(out_file) as out:
        for b in bedio.read(in_bed):
            spectrum = [0] * 6
            for v in tree.query(b, "any"):
                key = (v.ref, v.alt[0])
                if key not in _MUTATION_TYPE:
                    raise SystemExit(
                        f"Poorly formed VCF. Ref: {v.ref}. Alt: {v.alt[0]}.")
                spectrum[_MUTATION_TYPE[key]] += 1
            b.annotation = [str(c) for c in spectrum]
            b.fields_initialized = 13
            bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="divergenceSpectrum")
    p.add_argument("inBed")
    p.add_argument("inVcf")
    p.add_argument("output")
    a = p.parse_args(argv)
    divergence_spectrum(a.inBed, a.inVcf, a.output)


if __name__ == "__main__":
    main()
