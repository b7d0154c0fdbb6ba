"""SAM records and headers, the SAM and BAM readers and the writer: the
subset of ``gonomics_tpu/io/sam.py`` that the read aligner emits, the
variant caller reads and ``mergesort`` writes (the interval properties
:57-68, which scCount's index reads, the flag tests :72-83,
``parse_header_text`` :94, the text reader :122-153, the BAM decoder
:156-259 and its tag text :311-366, ``read`` :262, ``generate_header``
:270-280, ``write_sam`` :283 and ``read_header_text`` :469).
Records match the JAX reader's field for field."""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

from .. import dna, fileio
from . import cigar as samcigar
from .chrom_info import ChromInfo

BAM_MAGIC = b"BAM\x01"

# 4-bit BAM base -> dna code ("=ACMGRSVTWYHKDBN", unsupported -> NIL;
# bamRead.go baseDecoder)
_BASE_DECODER = np.full(16, dna.NIL, dtype=np.int8)
_BASE_DECODER[1] = dna.A
_BASE_DECODER[2] = dna.C
_BASE_DECODER[4] = dna.G
_BASE_DECODER[8] = dna.T
_BASE_DECODER[15] = dna.N


@dataclass
class Sam:
    qname: str = ""
    flag: int = 0
    rname: str = "*"
    pos: int = 0          # 1-based leftmost position
    mapq: int = 0
    cigar: list[samcigar.CigarOp] = field(default_factory=list)
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    qual: str = "*"
    extra: str = ""

    def to_string(self) -> str:
        base = (f"{self.qname}\t{self.flag}\t{self.rname}\t{self.pos}\t"
                f"{self.mapq}\t{samcigar.to_string(self.cigar)}\t{self.rnext}\t"
                f"{self.pnext}\t{self.tlen}\t{dna.to_string(self.seq)}\t"
                f"{self.qual}")
        return base + (f"\t{self.extra}" if self.extra else "")

    # interval.Interval methods (sam/methods.go:9-17)
    @property
    def chrom(self) -> str:
        return self.rname

    @property
    def chrom_start(self) -> int:
        return get_chrom_start(self)

    @property
    def chrom_end(self) -> int:
        return get_chrom_end(self)


# flag predicates (sam/flag.go)
def is_paired(s: Sam) -> bool: return bool(s.flag & 1)
def properly_aligned(s: Sam) -> bool: return bool(s.flag & 2)
def is_unmapped_flag(s: Sam) -> bool: return bool(s.flag & 4)
def mate_is_unmapped(s: Sam) -> bool: return bool(s.flag & 8)
def is_pos_strand(s: Sam) -> bool: return not s.flag & 16
def mate_is_pos_strand(s: Sam) -> bool: return not s.flag & 32
def is_forward_read(s: Sam) -> bool: return bool(s.flag & 64)
def is_reverse_read(s: Sam) -> bool: return bool(s.flag & 128)
def is_not_primary_align(s: Sam) -> bool: return bool(s.flag & 256)
def read_fails_qc(s: Sam) -> bool: return bool(s.flag & 512)
def is_duplicate(s: Sam) -> bool: return bool(s.flag & 1024)
def is_supplementary(s: Sam) -> bool: return bool(s.flag & 2048)


@dataclass
class Header:
    text: list[str] = field(default_factory=list)
    chroms: list[ChromInfo] = field(default_factory=list)
    sort_order: list[str] = field(default_factory=list)
    grouping: str = ""


def parse_header_text(text: list[str]) -> Header:
    """@SQ SN/LN -> chroms, @HD SO/SS -> sort_order, GO -> grouping
    (metadata.go:87)."""
    h = Header(text=list(text))
    order = 0
    for line in text:
        if line.startswith("@SQ"):
            name, size = "", 0
            for f in line.split("\t")[1:]:
                if f.startswith("SN:"):
                    name = f[3:]
                elif f.startswith("LN:"):
                    size = int(f[3:])
            h.chroms.append(ChromInfo(name, size, order))
            order += 1
        elif line.startswith("@HD"):
            for f in line.split("\t")[1:]:
                if f.startswith("SO:"):
                    h.sort_order = [f[3:]]
                elif f.startswith("SS:"):
                    h.sort_order = f[3:].split(":")[-1].split(",")
                elif f.startswith("GO:"):
                    h.grouping = f[3:]
    if not h.sort_order:
        h.sort_order = ["unknown"]
    return h


def _parse_sam_line(line: str) -> Sam:
    f = line.split("\t")
    seq = (np.zeros(0, np.int8) if f[9] == "*"
           else dna.from_string_upper_forced(f[9]))
    return Sam(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
               mapq=int(f[4]), cigar=samcigar.from_string(f[5]), rnext=f[6],
               pnext=int(f[7]), tlen=int(f[8]), seq=seq, qual=f[10],
               extra="\t".join(f[11:]) if len(f) > 11 else "")


def _is_bam(filename: str) -> bool:
    with open(filename, "rb") as f:
        magic = f.read(2)
        if magic != fileio.GZIP_MAGIC:
            return False
    with gzip.open(filename, "rb") as g:
        return g.read(4) == BAM_MAGIC


def read_sam_text(filename: str):
    """(header, records) of a text SAM file, gzipped or not."""
    header_lines: list[str] = []
    records: list[Sam] = []
    with fileio.easy_open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                header_lines.append(line)
            else:
                records.append(_parse_sam_line(line))
    return parse_header_text(header_lines), records


def _decode_seq(packed: bytes, l_seq: int) -> np.ndarray:
    raw = np.frombuffer(packed, dtype=np.uint8)
    out = np.empty(len(raw) * 2, dtype=np.int8)
    out[0::2] = _BASE_DECODER[raw >> 4]
    out[1::2] = _BASE_DECODER[raw & 0xF]
    return out[:l_seq]


def read_bam(filename: str):
    """Decode a BAM file: (header, refs, records), with sam.DecodeBam's
    field semantics (bamRead.go:157-270): RNext '=' where it names the
    read's own reference, qual 0xff -> '*'."""
    with open(filename, "rb") as f:
        raw = f.read()
    from .. import native

    data = native.bgzf_decompress(raw)  # threaded C++ path
    if data is None:
        data = gzip.decompress(raw)     # generic gzip fallback
    if data[:4] != BAM_MAGIC:
        raise ValueError("missing BAM magic bytes")
    mv = memoryview(data)
    off = 4
    l_text = struct.unpack_from("<I", mv, off)[0]
    off += 4
    text = bytes(mv[off:off + l_text]).decode().rstrip("\x00")
    off += l_text
    n_ref = struct.unpack_from("<I", mv, off)[0]
    off += 4
    refs: list[ChromInfo] = []
    for i in range(n_ref):
        l_name = struct.unpack_from("<I", mv, off)[0]
        off += 4
        name = bytes(mv[off:off + l_name - 1]).decode()
        off += l_name
        size = struct.unpack_from("<I", mv, off)[0]
        off += 4
        refs.append(ChromInfo(name, size, i))

    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    header = parse_header_text(lines)

    records: list[Sam] = []
    end = len(data)
    while off + 4 <= end:
        s, off = decode_bam_record(mv, off, refs)
        records.append(s)
    return header, refs, records


def decode_bam_record(mv, off: int, refs: list[ChromInfo]):
    """Decode one BAM alignment record starting at `off` (its 4-byte
    block_size prefix); returns (Sam, next offset). The tag bytes stay raw
    in ``_raw_tags``; ``_tags_to_text`` gives their SAM text."""
    blk = struct.unpack_from("<I", mv, off)[0]
    off += 4
    rec_end = off + blk
    (ref_id, pos, l_read_name, mapq, _bin, n_cig, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHIiii", mv,
                                                    off)
    off += 32
    s = Sam()
    s.rname = refs[ref_id].name if ref_id != -1 else "*"
    s.pos = pos + 1
    s.mapq = mapq
    s.flag = flag
    s.rnext = refs[next_ref].name if next_ref != -1 else "*"
    if s.rnext == s.rname and next_ref != -1:
        s.rnext = "="
    s.pnext = next_pos + 1
    s.tlen = tlen
    s.qname = bytes(mv[off:off + l_read_name - 1]).decode()
    off += l_read_name
    cigs = struct.unpack_from(f"<{n_cig}I", mv, off)
    off += 4 * n_cig
    s.cigar = [samcigar.CigarOp(c >> 4, samcigar.OP_TABLE[c & 0xF])
               for c in cigs]
    n_packed = (l_seq + 1) // 2
    s.seq = _decode_seq(bytes(mv[off:off + n_packed]), l_seq)
    off += n_packed
    qual = np.frombuffer(mv[off:off + l_seq], dtype=np.uint8)
    off += l_seq
    if l_seq > 0 and qual[0] == 0xFF:
        s.qual = "*"
    else:
        s.qual = (qual + 33).tobytes().decode("latin-1")
    s.extra = ""
    s._raw_tags = bytes(mv[off:rec_end])  # type: ignore[attr-defined]
    return s, rec_end


def get_chrom_start(s: Sam) -> int:
    """The record's 0-based start."""
    return s.pos - 1


def get_chrom_end(s: Sam) -> int:
    """The record's 0-based end: its start plus its cigar's reference
    length, the start itself where it has no cigar."""
    if not s.cigar or all(c.op == "*" for c in s.cigar):
        return s.pos - 1
    return s.pos - 1 + samcigar.reference_length(s.cigar)


def read(filename: str):
    """(header, records) of a SAM or BAM file, sniffed by content."""
    if _is_bam(filename):
        header, _refs, records = read_bam(filename)
        return header, records
    return read_sam_text(filename)


def generate_header(chroms: list[ChromInfo],
                    additional: list[str] | None = None,
                    sort_order: str = "unsorted",
                    grouping: str = "") -> Header:
    """@HD and one @SQ a chrom, then the additional lines, parsed
    (sam.py:270-280): ``GO:`` only where grouping is set and not
    ``none``."""
    text = [f"@HD\tVN:1.6\tSO:{sort_order}"]
    if grouping and grouping != "none":
        text[0] += f"\tGO:{grouping}"
    text.extend(f"@SQ\tSN:{c.name}\tLN:{c.size}" for c in chroms)
    text.extend(additional or [])
    return parse_header_text(text)


def write_sam(filename: str, header: Header, records: list[Sam]) -> None:
    """Text SAM, or BGZF BAM where the name ends in .bam
    (sam.py:283-297)."""
    if filename.endswith(".bam"):
        from .bam_writer import write_bam

        write_bam(filename, header, records)
        return
    with fileio.easy_create(filename) as f:
        for line in header.text:
            f.write(line + "\n")
        for r in records:
            f.write(r.to_string() + "\n")


def read_header_text(filename: str) -> Header:
    """Parse only the @ header lines of a SAM text file (the native
    pileup path tokenizes the alignment lines in C)."""
    lines = []
    with fileio.easy_open(filename) as f:
        for ln in f:
            if not ln.startswith("@"):
                break
            lines.append(ln.rstrip("\n"))
    return parse_header_text(lines)


# ---------------------------------------------------------------------------
# BAM auxiliary tags as SAM text (sam/tag.go)

def _f32_shortest(v: float) -> str:
    """strconv.FormatFloat(float64(v), 'f', -1, 32): shortest positional
    decimal that round-trips as float32 (tag.go:356,396)."""
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


_TAG_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
            "I": "<I", "f": "<f"}


def _tags_to_text(raw: bytes) -> str:
    """BAM tag bytes -> SAM text extra, as parseExtra +
    parsedExtraToString (tag.go:132-404): single c/C/s/S values print as
    ':i:'; single 'A' (char) tags are dropped."""
    parts: list[str] = []
    off = 0
    n = len(raw)
    while off < n:
        tag = raw[off:off + 2].decode("latin-1")
        typ = chr(raw[off + 2])
        off += 3
        if typ == "B":
            sub = chr(raw[off])
            count = struct.unpack_from("<I", raw, off + 1)[0]
            off += 5
            vals = []
            for _ in range(count):
                if sub == "Z":
                    end = raw.index(0, off)
                    vals.append(raw[off:end].decode("latin-1"))
                    off = end + 1
                elif sub == "H":
                    end = raw.index(0, off)
                    vals.append(raw[off:end].decode("latin-1").lower())
                    off = end + 1
                elif sub == "f":
                    vals.append(_f32_shortest(
                        struct.unpack_from("<f", raw, off)[0]))
                    off += 4
                else:
                    vals.append(str(struct.unpack_from(
                        _TAG_FMT[sub], raw, off)[0]))
                    off += _TAG_SIZES[sub]
            parts.append(f"{tag}:B:{sub}," + ",".join(vals))
        elif typ == "A":
            off += 1  # dropped from text (tag.go:parsedExtraToString)
        elif typ == "Z":
            end = raw.index(0, off)
            parts.append(f"{tag}:Z:" + raw[off:end].decode("latin-1"))
            off = end + 1
        elif typ == "H":
            end = raw.index(0, off)
            parts.append(f"{tag}:H:"
                         + raw[off:end].decode("latin-1").lower())
            off = end + 1
        elif typ == "f":
            parts.append(f"{tag}:f:" + _f32_shortest(
                struct.unpack_from("<f", raw, off)[0]))
            off += 4
        else:
            parts.append(f"{tag}:i:%d" % struct.unpack_from(
                _TAG_FMT[typ], raw, off)[0])
            off += _TAG_SIZES[typ]
    return "\t".join(parts)


def parse_extra(s: Sam) -> None:
    """A BAM record's raw tag bytes as its SAM text ``extra``, so that it
    can be edited; the raw bytes are dropped."""
    raw = getattr(s, "_raw_tags", None)
    if raw is not None:
        s.extra = _tags_to_text(raw)
        s._raw_tags = None  # type: ignore[attr-defined]


def remove_tag(s: Sam, tag_id: str) -> None:
    """Drops the first tag named tag_id from ``extra``; a tag at the start
    of ``extra`` is matched by its two letters alone."""
    if len(tag_id) != 2:
        raise ValueError("input tagId must be 2 characters")
    if s.extra == "":
        parse_extra(s)
    if s.extra.startswith(tag_id):
        end = s.extra.find("\t")
        s.extra = "" if end == -1 else s.extra[end + 1:]
        return
    start = s.extra.find("\t" + tag_id + ":")
    if start == -1:
        return
    end = s.extra.find("\t", start + 1)
    if end == -1:
        end = len(s.extra)
    s.extra = s.extra[:start] + s.extra[end:]


def add_tag(s: Sam, tag_id: str, typ: str, val: str) -> None:
    """Appends ``tag_id:typ:val`` to ``extra``."""
    if len(tag_id) != 2:
        raise ValueError("input tagId must be 2 characters")
    if typ not in ("A", "i", "f", "Z", "H", "B"):
        raise ValueError("input type must be one of A,i,f,Z,H,B")
    if s.extra == "":
        parse_extra(s)
    if s.extra == "":
        s.extra = f"{tag_id}:{typ}:{val}"
    else:
        s.extra = f"{s.extra}\t{tag_id}:{typ}:{val}"
