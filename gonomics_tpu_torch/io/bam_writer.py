"""BAM writing: BGZF-framed binary SAM records. A copy of
``gonomics_tpu/io/bam_writer.py`` whole (the BGZF EOF block :22,
``_bgzf_block`` :45, ``BgzfWriter`` :56, ``_reg2bin`` :93,
``_encode_tags`` :109, ``encode_bam_record`` :148, ``write_bam`` :177).

Text tags in ``Sam.extra`` ("XX:i:5\\tXY:Z:abc") are encoded to BAM's
binary tags; raw tag bytes kept by the BAM reader go back untouched.
Blocks are deflated over threads by the host library
(``native.compress_blocks``), else one after another with zlib: the
compressed bytes of the two may differ, the payload does not.
"""

from __future__ import annotations

import struct
import zlib
from typing import IO

import numpy as np

from .. import dna
from . import cigar as samcigar
from .sam import Header, Sam

# 28-byte BGZF EOF marker (bgzf spec / writer.go magic EOF)
BGZF_EOF = bytes([
    0x1F, 0x8B, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xFF, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1B, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])

_MAX_BLOCK = 0xFF00  # uncompressed payload per BGZF block

# dna code -> 4-bit bam code ("=ACMGRSVTWYHKDBN")
_BASE_ENC = np.zeros(13, np.uint8)
_BASE_ENC[dna.A] = 1
_BASE_ENC[dna.C] = 2
_BASE_ENC[dna.G] = 4
_BASE_ENC[dna.T] = 8
_BASE_ENC[dna.N] = 15
_BASE_ENC[dna.LOWER_A] = 1
_BASE_ENC[dna.LOWER_C] = 2
_BASE_ENC[dna.LOWER_G] = 4
_BASE_ENC[dna.LOWER_T] = 8
_BASE_ENC[dna.LOWER_N] = 15

_OP_NUM = {op: i for i, op in enumerate(samcigar.OP_TABLE)}


def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    bsize = len(data) + 25 + 1  # header(18) + deflate + crc(4) + isize(4)
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       ord("B"), ord("C"), 2, bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return head + data + tail


class BgzfWriter:
    """BGZF block writer: blocks deflated over threads by the host
    library, or one after another with zlib without it. Buffers 64
    blocks so that each flush hands the threads many."""

    FLUSH_AT = 64 * _MAX_BLOCK

    def __init__(self, fh: IO[bytes]):
        self.fh = fh
        self.buf = bytearray()

    def _flush(self, everything: bool) -> None:
        from .. import native

        keep = 0 if everything else len(self.buf) % _MAX_BLOCK
        chunk = bytes(self.buf[:len(self.buf) - keep])
        if not chunk:
            return
        del self.buf[:len(chunk)]
        comp = native.compress_blocks(chunk, bgzf=True)
        if comp is not None:
            self.fh.write(comp)
            return
        for off in range(0, len(chunk), _MAX_BLOCK):
            self.fh.write(_bgzf_block(chunk[off:off + _MAX_BLOCK]))

    def write(self, data: bytes) -> None:
        self.buf.extend(data)
        if len(self.buf) >= self.FLUSH_AT:
            self._flush(everything=False)

    def close(self) -> None:
        self._flush(everything=True)
        self.fh.write(BGZF_EOF)


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec bin calculation."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_tags(extra: str) -> bytes:
    out = bytearray()
    if not extra:
        return bytes(out)
    for field in extra.split("\t"):
        parts = field.split(":", 2)
        if len(parts) != 3:
            continue
        tag, typ, val = parts
        out.extend(tag.encode())
        if typ == "i":
            out.append(ord("i"))
            out.extend(struct.pack("<i", int(val)))
        elif typ == "f":
            out.append(ord("f"))
            out.extend(struct.pack("<f", float(val)))
        elif typ == "A":
            out.append(ord("A"))
            out.append(ord(val[0]))
        elif typ == "B":  # array: "B:X,v1,v2,..." (bamWrite.go:writeTriplet)
            sub = val[0]
            vals = val[2:].split(",") if len(val) > 2 else []
            out.append(ord("B"))
            out.append(ord(sub))
            out.extend(struct.pack("<I", len(vals)))
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                   "i": "<i", "I": "<I", "f": "<f"}[sub]
            conv = float if sub == "f" else int
            for v in vals:
                out.extend(struct.pack(fmt, conv(v)))
        elif typ == "H":
            out.append(ord("H"))
            out.extend(bytes.fromhex(val) + b"\x00")
        else:  # Z and anything else as NUL-terminated string
            out.append(ord("Z"))
            out.extend(val.encode() + b"\x00")
    return bytes(out)


def encode_bam_record(s: Sam, ref_ids: dict[str, int]) -> bytes:
    ref_id = ref_ids.get(s.rname, -1)
    next_ref = ref_id if s.rnext == "=" else ref_ids.get(s.rnext, -1)
    name = s.qname.encode() + b"\x00"
    cig = [] if samcigar.is_unmapped(s.cigar) else s.cigar
    cig_bytes = b"".join(struct.pack("<I", (c.run_length << 4)
                                     | _OP_NUM[c.op]) for c in cig)
    seq = np.asarray(s.seq, np.int64)
    l_seq = len(seq)
    codes = _BASE_ENC[seq]
    if l_seq % 2:
        codes = np.concatenate([codes, np.zeros(1, np.uint8)])
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    if s.qual == "*" or not s.qual:
        qual = b"\xff" * l_seq
    else:
        qual = bytes((ord(c) - 33) & 0xFF for c in s.qual)
    tags = getattr(s, "_raw_tags", None)
    if tags is None:
        tags = _encode_tags(s.extra)
    end = s.pos - 1 + max(1, samcigar.reference_length(cig))
    body = struct.pack(
        "<iiBBHHHIiii", ref_id, s.pos - 1, len(name), s.mapq,
        _reg2bin(max(0, s.pos - 1), max(1, end)), len(cig), s.flag, l_seq,
        next_ref, s.pnext - 1 if s.pnext else -1, s.tlen)
    rec = body + name + cig_bytes + packed + qual + tags
    return struct.pack("<I", len(rec)) + rec


def write_bam(filename: str, header: Header, records: list[Sam]) -> None:
    text = "\n".join(header.text) + "\n" if header.text else ""
    with open(filename, "wb") as fh:
        w = BgzfWriter(fh)
        w.write(b"BAM\x01")
        w.write(struct.pack("<I", len(text)))
        w.write(text.encode())
        w.write(struct.pack("<I", len(header.chroms)))
        for c in header.chroms:
            name = c.name.encode() + b"\x00"
            w.write(struct.pack("<I", len(name)) + name
                    + struct.pack("<I", c.size))
        ref_ids = {c.name: i for i, c in enumerate(header.chroms)}
        for s in records:
            w.write(encode_bam_record(s, ref_ids))
        w.close()
