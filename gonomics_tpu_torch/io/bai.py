"""BAI index reading and BAM region seeks: all of
``gonomics_tpu/io/bai.py`` (``Reference`` :17, ``Bai`` :25, ``read_bai``
:32, ``region_to_bins`` :70, ``_BgzfStream`` :83, ``seek_bam_region``
:132, ``_deduplicate`` :177, the two caches :190-207).

The binning and the 16 kbp linear index follow the SAM spec. A seek
jumps to a chunk's BGZF virtual offset (coffset << 16 | uoffset),
inflates blocks as it reads, and decodes records with the SAM module's
BAM record decoder. The reference's quirks are kept: no root bin 0 for
a mapped region, a chunk's end offset is not a stop (a seek reads on
until a record on another chrom or one starting at or past ``end``), and
the result is de-duplicated by (QName, first-in-pair flag) in name
order. The caches hold each BAM's bytes and header by path for the life
of the process.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

from . import sam as samio


@dataclass
class Reference:
    """One reference's bins (bin id -> [(chunk start, chunk end)]) and
    its 16 kbp linear index."""

    bins: dict[int, list[tuple[int, int]]] = field(default_factory=dict)
    interval_off: list[int] = field(default_factory=list)


@dataclass
class Bai:
    refs: list[Reference] = field(default_factory=list)
    has_no_coord_reads: bool = False
    no_coord_reads: int = 0


def read_bai(filename: str) -> Bai:
    """A .bai file; ValueError on a bad magic or trailing bytes."""
    with open(filename, "rb") as f:
        data = f.read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"malformed bai header in '{filename}'")
    off = 4
    bai = Bai()
    (n_ref,) = struct.unpack_from("<I", data, off)
    off += 4
    for _ in range(n_ref):
        ref = Reference()
        (n_bin,) = struct.unpack_from("<I", data, off)
        off += 4
        for _ in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<II", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                start, end = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((start, end))
            ref.bins[bin_id] = chunks
        (n_intv,) = struct.unpack_from("<I", data, off)
        off += 4
        ref.interval_off = list(struct.unpack_from(f"<{n_intv}Q", data,
                                                   off))
        off += 8 * n_intv
        bai.refs.append(ref)
    if len(data) - off == 8:
        bai.has_no_coord_reads = True
        (bai.no_coord_reads,) = struct.unpack_from("<Q", data, off)
        off += 8
    if off != len(data):
        raise ValueError(f"extra {len(data) - off} bytes in bai file")
    return bai


def region_to_bins(beg: int, end: int) -> list[int]:
    """The bins of levels 1-5 that [beg, end) touches (root bin 0 is not
    among them, as in the reference); (-1, 0) gives the unmapped bins."""
    if beg == -1 and end == 0:
        return [0, 0, 8, 72, 584, 4680]
    ans: list[int] = []
    end -= 1
    for base, shift in ((1, 26), (9, 23), (73, 20), (585, 17),
                        (4681, 14)):
        ans.extend(range(base + (beg >> shift),
                         base + (end >> shift) + 1))
    return ans


class _BgzfStream:
    """Sequential reader over the BGZF blocks of data from a compressed
    offset on."""

    def __init__(self, data: bytes, coffset: int):
        self.data = data
        self.coffset = coffset
        self.buf = b""
        self.pos = 0

    def _load_block(self) -> bool:
        if self.coffset >= len(self.data) - 27:
            return False
        header = self.data[self.coffset:self.coffset + 18]
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = self.data[self.coffset + 12:self.coffset + 12 + xlen]
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from(
                "<H", extra, i + 2)[0]
            if si1 == 66 and si2 == 67:  # 'B','C'
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC extra field")
        member = self.data[self.coffset:self.coffset + bsize]
        out = zlib.decompressobj(wbits=31).decompress(member)
        self.coffset += bsize
        self.buf = self.buf[self.pos:] + out
        self.pos = 0
        return len(out) > 0 or bsize > 28

    def skip(self, n: int) -> None:
        self.read(n)

    def read(self, n: int) -> bytes:
        while len(self.buf) - self.pos < n:
            before = len(self.buf) - self.pos
            if not self._load_block() and \
                    len(self.buf) - self.pos == before:
                break
        out = self.buf[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def seek_bam_region(bam_file: str, bai: Bai, chrom: str, start: int,
                    end: int):
    """The records of bam_file that overlap [start, end) on chrom,
    de-duplicated (``_deduplicate``); [] for a chrom the header lacks or
    a start past the linear index."""
    if start > end:
        raise ValueError("SeekBamRegion input start > end")
    refs = _bam_header_cache(bam_file)[1]
    data = _raw_cache(bam_file)
    ref_idx = next((c.order for c in refs if c.name == chrom), None)
    if ref_idx is None:
        return []
    ref = bai.refs[ref_idx]
    if start // 16384 >= len(ref.interval_off):
        return []
    linear_min_coffset = ref.interval_off[start // 16384] >> 16

    ans: list[samio.Sam] = []
    for bin_id in region_to_bins(start, end):
        for cstart, cend in ref.bins.get(bin_id, []):
            uoffset = cstart & 0xFFFF
            coffset = cstart >> 16
            if (cend >> 16) < linear_min_coffset:
                continue
            stream = _BgzfStream(data, coffset)
            stream.skip(uoffset)
            while True:
                prefix = stream.read(4)
                if len(prefix) < 4:
                    break
                (blk,) = struct.unpack("<I", prefix)
                body = stream.read(blk)
                if len(body) < blk:
                    break
                s, _ = samio.decode_bam_record(
                    memoryview(prefix + body), 0, refs)
                if (s.rname == chrom
                        and samio.get_chrom_end(s) > start
                        and samio.get_chrom_start(s) < end):
                    ans.append(s)
                if (s.rname == chrom
                        and samio.get_chrom_start(s) >= end) \
                        or s.rname != chrom:
                    break
    return _deduplicate(ans)


def _deduplicate(records):
    """One record a (QName, first-in-pair flag), sorted by name with the
    flagged read first."""
    records.sort(key=lambda s: (s.qname,
                                not samio.is_forward_read(s)))
    ans = []
    for s in records:
        if not ans or not (s.qname == ans[-1].qname
                           and samio.is_forward_read(s)
                           == samio.is_forward_read(ans[-1])):
            ans.append(s)
    return ans


_header_cache: dict[str, tuple] = {}
_data_cache: dict[str, bytes] = {}


def _raw_cache(bam_file: str) -> bytes:
    if bam_file not in _data_cache:
        with open(bam_file, "rb") as f:
            _data_cache[bam_file] = f.read()
    return _data_cache[bam_file]


def _bam_header_cache(bam_file: str):
    if bam_file not in _header_cache:
        header, refs, _records = samio.read_bam(bam_file)
        _header_cache[bam_file] = (header, refs)
    h, r = _header_cache[bam_file]
    return h, r, None
