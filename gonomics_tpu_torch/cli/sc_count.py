"""scCount: a count matrix of single-cell reads over genes; a copy of
``gonomics_tpu/cli/sc_count.py`` (110 lines, whole), gonomics'
``cmd/scCount``.

    gonomics-torch scCount reads.sam genes.gtf out.tsv
        [-expNormalizationFile norm.tsv]

The reads carry ``_BX:<barcode>`` and ``_UMI:<umi>`` in their names and
are sorted by barcode. Each read's barcode is parsed before its overlap
is looked up (a read with neither exits, overlap or not); the genes are
indexed in sorted ``gene_id`` order by their first transcript's span; a
read over two genes exits. A row starts at each change of barcode among
the reads that overlap a gene; counts are floats written with Go's
``%g``, multiplied by the normalisation table's value at write time.
With no overlapping read the output is the header and the line ``\t``.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..interval import IntervalIndex
from ..io import gtf as gtfio
from ..io import sam as samio
from ..io.wig import go_fmt_g


def parse_bx_and_umi(qname: str) -> tuple[str, str]:
    """sam.parseBxAndUmiFromAln (sam/singleCell.go:27-51)."""
    bx = umi = None
    for field in qname.split("_"):
        if field.startswith("UMI:"):
            umi = field.split(":")[1]
        if field.startswith("BX:"):
            bx = field.split(":")[1]
    if bx is None:
        raise SystemExit("Failed to parse Barcode from single-cell read "
                         "name.")
    if umi is None:
        raise SystemExit("Failed to parse Umi from single-cell read name.")
    return bx, umi


def parse_norm_map(norm_file: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for line in fileio.read(norm_file):
        words = line.split("\t")
        if len(words) != 2:
            raise SystemExit("Expression normalization input file must be "
                             "a tab-separated file with two columns per "
                             "line.")
        out[words[0]] = float(words[1])
    return out


def sc_count(in_file: str, gene_file: str, out_file: str,
             exp_normalization_file: str = "") -> None:
    _header, reads = samio.read(in_file)
    genes = gtfio.read(gene_file)
    gene_ids = sorted(genes)
    gene_index = {genes[g].gene_id: c for c, g in enumerate(gene_ids)}
    tree = IntervalIndex([genes[g] for g in gene_ids])

    norm_map: dict[str, float] = {}
    if exp_normalization_file:
        norm_map = parse_norm_map(exp_normalization_file)

    def norm_and_print(out, bx: str, counts: list[float]) -> None:
        if exp_normalization_file:
            for i, g in enumerate(gene_ids):
                if g in norm_map:
                    counts[i] *= norm_map[g]
        out.write(bx + "\t" + "\t".join(go_fmt_g(c) for c in counts) + "\n")

    with fileio.easy_create(out_file) as out:
        out.write("Bx" + "".join(f"\t{g}" for g in gene_ids) + "\n")
        cur_bx = ""
        cur_counts: list[float] = []
        first = True
        for rec in reads:
            bx, _umi = parse_bx_and_umi(rec.qname)
            overlap = tree.query(rec, "any")
            if not overlap:
                continue
            if len(overlap) > 1:
                raise SystemExit("The following input SAM record maps to "
                                 "multiple genes in the gtf file:\n"
                                 f"{rec.to_string()}.")
            gene = overlap[0].gene_id
            if bx != cur_bx:
                if first:
                    first = False
                else:
                    norm_and_print(out, cur_bx, cur_counts)
                cur_bx = bx
                cur_counts = [0.0] * len(gene_index)
            cur_counts[gene_index[gene]] += 1
        norm_and_print(out, cur_bx, cur_counts)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="scCount")
    p.add_argument("reads")
    p.add_argument("genes")
    p.add_argument("output")
    p.add_argument("-expNormalizationFile", default="")
    a = p.parse_args(argv)
    sc_count(a.reads, a.genes, a.output,
             exp_normalization_file=a.expNormalizationFile)


if __name__ == "__main__":
    main()
