"""VCF records as the variant-graph construction reads them: the ``Vcf``
record and the type tests of ``gonomics_tpu/io/vcf.py`` (:48, :305-323),
without the readers, writers and samples."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Vcf:
    chrom: str = ""
    pos: int = 0
    id: str = "."
    ref: str = ""
    alt: list[str] = field(default_factory=list)
    info: str = "."


def snp(v: Vcf) -> bool:
    """Info holds SVTYPE=SNP (also true for SVTYPE=SNP;INS and
    SVTYPE=SNP;DEL haplotype blocks)."""
    return "SVTYPE=SNP" in v.info


def ins(v: Vcf) -> bool:
    return "SVTYPE=INS" in v.info


def dele(v: Vcf) -> bool:
    return "SVTYPE=DEL" in v.info


def sort(records: list[Vcf]) -> None:
    """In place, by (chrom, pos)."""
    records.sort(key=lambda v: (v.chrom, v.pos))
