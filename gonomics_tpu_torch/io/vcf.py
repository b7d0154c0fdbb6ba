"""VCF records, header, reader and writer, as the variant-graph
construction and ``gsw ggtools`` read them and the variant caller and
``ggtools`` write them: ``Sample`` (:16), ``_fmt_qual`` (:40), ``Vcf``
(:48), ``Header`` (:71), ``new_write_header`` (:75), ``write_vcf`` (:80),
the reader (``_parse_samples`` :84, ``read`` :114, ``process_vcf_line``
:130), the type tests and ``sort`` (:305-328), ``is_vcf_file`` (:326) and
``new_header`` (:331) of ``gonomics_tpu/io/vcf.py``, and its header
metadata and typed INFO/FORMAT parsing (:150-284: the type constants,
``Key``, ``HeaderMeta``, ``_angle_fields``, ``parse_header_meta``,
``get_number``, ``_parse_value``, ``parse_info``, ``parse_format``) that
vcfFormat, vcfToFa and vcfFilter read; the sample-list helpers
``header_get_sample_list`` and ``header_update_sample_list`` (:286-303)
and the genotype and ancestor helpers ``is_homozygous``,
``is_heterozygous``, ``append_ancestor``,
``annotate_ancestor_from_multi_fa`` and ``ancestor_flag_to_header``
(:338-397) of the vcf_sampling tools and alleleSplit. ``to_string`` gives
Vcf.String()/Sample.String() byte for byte."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO

from .. import dna, fileio
from . import fasta as fastaio


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


# --- header metadata and typed INFO/FORMAT parsing (vcf/header.go,
#     queryInfo.go) ---

INTEGER, FLOAT, FLAG, CHARACTER, STRING = ("Integer", "Float", "Flag",
                                           "Character", "String")


@dataclass
class Key:
    """vcf.Key (header.go): tag id + Number spec + data type."""
    id: str = ""
    number: str = "1"
    data_type: str = STRING
    is_format: bool = False


@dataclass
class HeaderMeta:
    """Parsed ##INFO / ##FORMAT lines + sample column order
    (vcf.Header Info/Format/Samples maps; file order preserved)."""
    info: dict[str, Key] = field(default_factory=dict)
    format: dict[str, Key] = field(default_factory=dict)
    samples: list[str] = field(default_factory=list)


def _angle_fields(body: str) -> dict[str, str]:
    """KEY=value pairs of a ##INFO/##FORMAT line's <...> body, split at
    commas outside double quotes; values lose their outer quotes."""
    out, cur, in_q = {}, [], False
    parts = []
    for ch in body:
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            out[k] = v.strip('"')
    return out


def parse_header_meta(header: Header) -> HeaderMeta:
    """The ##INFO and ##FORMAT keys in file order, and the #CHROM line's
    sample names."""
    m = HeaderMeta()
    for line in header.text:
        if line.startswith("##INFO=<") and line.endswith(">"):
            f = _angle_fields(line[len("##INFO=<"):-1])
            m.info[f["ID"]] = Key(f["ID"], f.get("Number", "1"),
                                  f.get("Type", STRING), False)
        elif line.startswith("##FORMAT=<") and line.endswith(">"):
            f = _angle_fields(line[len("##FORMAT=<"):-1])
            m.format[f["ID"]] = Key(f["ID"], f.get("Number", "1"),
                                    f.get("Type", STRING), True)
        elif line.startswith("#CHROM"):
            cols = line.split("\t")
            if len(cols) > 9:
                m.samples = cols[9:]
    return m


def get_number(v: Vcf, k: Key) -> int:
    """queryInfo.go:208 getNumber."""
    if k.number == "A":
        return len(v.alt)
    if k.number == "R":
        return len(v.alt) + 1
    if k.number == "G":
        return 1
    if k.number == ".":
        return 0
    return int(k.number)


def _parse_value(v: Vcf, values: list[str], k: Key):
    """queryInfo.go:75 parseValue: a list of per-sample strings as typed
    lists. '.' reads as zero, and a numeric list that is one zero becomes
    get_number zeros; String keeps its commas; Character is the first
    character of the first field."""
    if k.data_type == INTEGER:
        data = [[0 if x == "." else int(x) for x in s.split(",")]
                for s in values]
        data = [([0] * get_number(v, k) if len(d) == 1 and d[0] == 0 else d)
                for d in data]
        return data
    if k.data_type == FLOAT:
        data = [[0.0 if x == "." else float(x) for x in s.split(",")]
                for s in values]
        data = [([0.0] * get_number(v, k)
                 if len(d) == 1 and d[0] == 0 else d) for d in data]
        return data
    if k.data_type == STRING:
        return [[s] for s in values]  # literal commas kept (queryInfo.go:140)
    if k.data_type == CHARACTER:
        return [list(s.split(",")[0][:1]) if s else [] for s in values]
    raise ValueError(f"unknown type {k.data_type}")


def parse_info(v: Vcf, meta: HeaderMeta) -> dict:
    """vcf.ParseInfo (queryInfo.go:14)."""
    parsed: dict = {}
    if v.info == ".":
        return parsed
    for fld in v.info.split(";"):
        pair = fld.split("=")
        tag = meta.info.get(pair[0])
        if tag is None:
            raise ValueError(f"Info tag '{pair[0]}' not in header")
        if tag.number == "0":
            parsed[pair[0]] = True
            continue
        parsed[pair[0]] = _parse_value(v, pair[1:], tag)
    return parsed


def parse_format(v: Vcf, meta: HeaderMeta) -> dict:
    """vcf.ParseFormat (queryInfo.go:46): GT is skipped."""
    parsed: dict = {}
    if not v.format:
        return parsed
    for i, name in enumerate(v.format):
        if name == "GT":
            continue
        tag = meta.format.get(name)
        if tag is None:
            raise ValueError(f"Format tag '{name}' not in header")
        vals = []
        for s in v.samples:
            fd = s.format_data or []
            vals.append(fd[i] if i < len(fd) else "")
        parsed[name] = _parse_value(v, vals, tag)
    return parsed


def header_get_sample_list(header: Header) -> list[str]:
    """The sample names of the #CHROM line; exits where there is none
    (vcf.py:286-292)."""
    for line in header.text:
        if line.startswith("#CHROM"):
            return line.split("\t")[9:]
    raise SystemExit("No Sample info in VCF line, cannot parse sample "
                     "names.")


def header_update_sample_list(header: Header,
                              new_samples: list[str]) -> Header:
    """A copy of header whose #CHROM lines name new_samples
    (vcf.py:295-302)."""
    out = Header(text=list(header.text))
    for i, line in enumerate(out.text):
        if line.startswith("#CHROM"):
            out.text[i] = "\t".join(line.split("\t")[:9] + new_samples)
    return out


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


def is_homozygous(s: Sample) -> bool:
    """Two alleles, equal (vcf.py:338-341)."""
    return (s.alleles is not None and len(s.alleles) == 2
            and s.alleles[0] == s.alleles[1])


def is_heterozygous(s: Sample) -> bool:
    """Two alleles, different (vcf.py:344-346)."""
    return (s.alleles is not None and len(s.alleles) == 2
            and s.alleles[0] != s.alleles[1])


def append_ancestor(v: Vcf, bases: str) -> Vcf:
    """AA=bases appended to INFO, or in place of an INFO of "."
    (vcf.py:349-353)."""
    v.info = (f"AA={bases}" if v.info == "."
              else f"{v.info};AA={bases}")
    return v


def annotate_ancestor_from_multi_fa(v: Vcf, records, ref_start: int,
                                    aln_start: int):
    """AA= from row 1 of an alignment at v's column in row 0, the allele
    running over the gaps that follow it in row 0 (vcf.py:356-374).
    Returns (v, the reference position and the column to start the next
    search from)."""
    p = fastaio.ref_pos_to_aln_pos_counter(records[0], v.pos - 1,
                                           ref_start, aln_start)
    ref_seq = records[0].seq
    anc_seq = records[1].seq
    if p + 1 < len(ref_seq) and ref_seq[p + 1] == dna.GAP:
        end = p + 1
        while end < len(ref_seq) and ref_seq[end] == dna.GAP:
            end += 1
        allele = dna.to_string(anc_seq[p:end])
    else:
        allele = dna.to_string(anc_seq[p:p + 1])
    v = append_ancestor(v, allele)
    return v, v.pos - 1, p


def ancestor_flag_to_header(header: Header) -> Header:
    """A copy of header with the AA INFO line after the last ##INFO,
    else before the first ##FORMAT, else at the end (vcf.py:377-397)."""
    line = ('##INFO=<ID=AA,Number=1,Type=String,'
            'Description="AncestralAllele">')
    last_info = -1
    first_format = -1
    for i, txt in enumerate(header.text):
        key = txt.split("=")[0]
        if key == "##INFO":
            last_info = i
        if key == "##FORMAT" and first_format == -1:
            first_format = i
    out = list(header.text)
    if last_info == -1:
        if first_format == -1:
            out.append(line)
        else:
            out.insert(first_format, line)
    else:
        out.insert(last_info + 1, line)
    return Header(text=out)
