"""VCF records, header, reader and writer, as the variant-graph
construction and ``gsw ggtools`` read them and the variant caller and
``ggtools`` write them: ``Sample`` (:16), ``_fmt_qual`` (:40), ``Vcf``
(:48), ``Header`` (:71), ``new_write_header`` (:75), ``write_vcf`` (:80),
the reader (``_parse_samples`` :84, ``read`` :114, ``process_vcf_line``
:130), the type tests and ``sort`` (:305-328), ``is_vcf_file`` (:326) and
``new_header`` (:331) of ``gonomics_tpu/io/vcf.py``. ``to_string`` gives
Vcf.String()/Sample.String() byte for byte."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

from .. import fileio


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


def _parse_samples(fields: list[str],
                   fmt: list[str] | None = None) -> list[Sample]:
    """Genotypes parse only where the first format key is GT; a '.'
    format gives no samples."""
    if fmt is not None and (not fmt or fmt[0] == "."):
        return []
    has_gt = fmt is None or fmt[0] == "GT"
    out = []
    for s in fields:
        sm = Sample()
        data = s.split(":")
        gt = data[0]
        if not has_gt:
            sm.alleles = None
            sm.format_data = list(data)
            out.append(sm)
            continue
        if gt in (".", "") or all(x == "." for x in
                                  gt.replace("|", "/").split("/")):
            sm.alleles = None
        else:
            phased = "|" in gt
            alleles = gt.replace("|", "/").split("/")
            sm.alleles = [-1 if a == "." else int(a) for a in alleles]
            sm.phase = [phased] * len(sm.alleles)
        sm.format_data = [""] + data[1:]
        out.append(sm)
    return out


def read(filename: str) -> tuple[list[Vcf], Header]:
    """(records, header) of a VCF file; '#' lines make the header."""
    header = Header()
    records: list[Vcf] = []
    with fileio.easy_open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                header.text.append(line)
                continue
            records.append(process_vcf_line(line))
    return records, header


def process_vcf_line(line: str) -> Vcf:
    """One data line; a '.' quality reads as 255."""
    f = line.split("\t")
    v = Vcf(chrom=f[0], pos=int(f[1]), id=f[2], ref=f[3],
            alt=f[4].split(",") if f[4] else [],
            qual=float(f[5]) if f[5] != "." else 255.0,
            filter=f[6], info=f[7])
    if len(f) > 8:
        v.format = f[8].split(":")
        v.samples = _parse_samples(f[9:], v.format)
    return v


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


def is_vcf_file(filename: str) -> bool:
    return filename.endswith(".vcf") or filename.endswith(".vcf.gz")


def new_header() -> Header:
    """The two-line header that ``gsw ggtools`` writes."""
    return Header(text=[
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"])
