"""VCF records, header and writer, as the variant-graph construction
reads them and the variant caller writes them: ``Sample`` (:16),
``_fmt_qual`` (:40), ``Vcf`` (:48), ``Header`` (:71), ``new_write_header``
(:75), ``write_vcf`` (:80) and the type tests (:305-323) of
``gonomics_tpu/io/vcf.py``, without the readers. ``to_string`` gives
Vcf.String()/Sample.String() byte for byte."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO


@dataclass
class Sample:
    alleles: list[int] | None = None
    phase: list[bool] = field(default_factory=list)
    format_data: list[str] | None = None

    def to_string(self) -> str:
        if self.format_data is None:
            return "."
        parts = []
        if self.alleles is None:
            parts.append(".")
        else:
            for i, a in enumerate(self.alleles):
                if 0 < i < len(self.phase):
                    parts.append("|" if self.phase[i] else "/")
                parts.append(str(a))
        s = "".join(parts)
        if self.format_data:
            if self.format_data[0] != "":
                s += ":"
            s += ":".join(self.format_data)
        return s


def _fmt_qual(q: float) -> str:
    """strconv.FormatFloat(q, 'f', -1, 64): shortest 'f' representation."""
    if q == int(q) and abs(q) < 1e15:
        return str(int(q))
    return repr(q)


@dataclass
class Vcf:
    chrom: str = ""
    pos: int = 0
    id: str = "."
    ref: str = ""
    alt: list[str] = field(default_factory=list)
    qual: float = 0.0
    filter: str = ""
    info: str = "."
    format: list[str] = field(default_factory=list)
    samples: list[Sample] = field(default_factory=list)

    def to_string(self) -> str:
        s = (f"{self.chrom}\t{self.pos}\t{self.id}\t{self.ref}\t"
             f"{','.join(self.alt)}\t{_fmt_qual(self.qual)}\t{self.filter}\t"
             f"{self.info}")
        if self.format:
            s += "\t" + ":".join(self.format)
            s += "\t" + "\t".join(x.to_string() for x in self.samples)
        return s


@dataclass
class Header:
    text: list[str] = field(default_factory=list)


def new_write_header(f: IO[str], header: Header) -> None:
    for line in header.text:
        f.write(line + "\n")


def write_vcf(f: IO[str], record: Vcf) -> None:
    f.write(record.to_string() + "\n")


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
