"""digestGenome: the restriction fragments of a FASTA file as bed
records, a copy of ``gonomics_tpu/cli/digest_genome.py`` (95 lines), its
arguments unchanged.

    gonomics-torch digestGenome in.fa MboI|DnpII|BglII|HindIII|G^ATC out.bed

A motif names one of the four default enzymes (the reference's spelling
"DnpII" kept) or is a site with ``^`` at the cut. A non-palindromic site
cuts on the reverse strand too, at ``k - cut`` from its start. The
``last`` flag fires one base before the final window (digest_genome.py:
58-60), so a cut site in a record's last k bases writes its fragment
after the one that ends at the record's length.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio

# default Hi-C enzymes (digestGenome.go:52-76; "DnpII" spelling is the
# reference's)
_DEFAULTS = {
    "MboI": (0, "GATC"),
    "DnpII": (0, "GATC"),
    "BglII": (1, "AGATCT"),
    "HindIII": (1, "AAGCTT"),
}


def _get_cut_pos(cut_site: str) -> tuple[int, str]:
    if "^" not in cut_site:
        raise SystemExit("The input restriction enzyme cut site must have "
                         "the '^' character to denote the cut location. "
                         f"Your seq: {cut_site}")
    pos = cut_site.index("^")
    return pos, cut_site.replace("^", "")


def digest_genome(genome: str, cut_site: str, out_file: str) -> None:
    if cut_site in _DEFAULTS:
        cut_pos, motif = _DEFAULTS[cut_site]
    else:
        cut_pos, motif = _get_cut_pos(cut_site)
    cut_bases = dna.from_string(motif)
    cut_rc = dna.reverse_complement(np.array(cut_bases, copy=True))
    pal = dna.compare_seqs_ignore_case(cut_bases, cut_rc) == 0
    k = len(cut_bases)

    with fileio.easy_create(out_file) as out:
        for rec in fastaio.read(genome):
            seq_up = dna.to_upper(np.asarray(rec.seq))
            fwd = np.zeros(max(len(seq_up) - k + 1, 0), dtype=bool)
            rev = np.zeros_like(fwd)
            if len(fwd):
                fwd[:] = True
                rev[:] = True
                for j in range(k):
                    sl = seq_up[j:j + len(fwd)]
                    fwd &= sl == dna.to_upper(cut_bases[j:j + 1])[0]
                    rev &= sl == dna.to_upper(cut_rc[j:j + 1])[0]
            prev_cut = num_cut = 0
            for base in range(len(rec.seq) - k + 1):
                rev_match = (not pal) and bool(rev[base])
                last = base + 1 == len(rec.seq) - k
                if bool(fwd[base]) or last or rev_match:
                    if last:
                        region = bedio.Bed(
                            chrom=rec.name, chrom_start=prev_cut,
                            chrom_end=len(rec.seq),
                            name=f"{cut_site}_{rec.name}_{num_cut}",
                            strand="+", fields_initialized=6)
                    elif rev_match:
                        end = base + (k - cut_pos)
                        region = bedio.Bed(
                            chrom=rec.name, chrom_start=prev_cut,
                            chrom_end=end,
                            name=f"{cut_site}_{rec.name}_{num_cut}",
                            strand="-", fields_initialized=6)
                        prev_cut = end
                    else:
                        region = bedio.Bed(
                            chrom=rec.name, chrom_start=prev_cut,
                            chrom_end=base + cut_pos,
                            name=f"{cut_site}_{rec.name}_{num_cut}",
                            strand="+", fields_initialized=6)
                        prev_cut = base + cut_pos
                    bedio.write_to_handle(out, region)
                    num_cut += 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="digestGenome")
    p.add_argument("input")
    p.add_argument("motif")
    p.add_argument("output")
    a = p.parse_args(argv)
    digest_genome(a.input, a.motif, a.output)


if __name__ == "__main__":
    main()
