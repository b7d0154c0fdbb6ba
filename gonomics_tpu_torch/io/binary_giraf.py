"""Binary giraf (.giraf.fe): bgzf-framed, 3-bit seq, run-length quals;
a copy of ``gonomics_tpu/io/binary_giraf.py`` (285 lines, whole),
gonomics' ``giraf/binaryGiraf`` (binWriter.go:60-291,
binReader.go:64-280). Record layout (little endian):

  blockSize u32 | qNameLen u8 | qName | flag u8 | tStart u32 | tEnd u32 |
  pathLen u32 | path u32[] | numCigarOps u32 | (runLen u16, op u8)[] |
  fancySeqLen u32 | fancySeq u64[] | alnScore i64 | mapQ u8 |
  numQualOps u16 | (runLen u16, qual u8)[] | notes...

fancySeq holds only the bases not recoverable from the graph (S/X/I ops),
3-bit packed with A padding; the reader reconstructs the full read from
the graph nodes along the path. The format has no strand column: the
reader sets the strand from flag bit 8, so a round trip turns a '+'
record without that bit to '-', as gonomics' reader does. The writer's
blocks are deflated as ``io/bam_writer.BgzfWriter`` deflates them.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from .. import dna_threebit as tb
from . import cigar as samcigar
from . import giraf as girafio
from .bam_writer import BgzfWriter
from .giraf import Giraf, Note


def _get_fancy_seq(seq, cigars) -> tb.ThreeBit:
    """getFancySeq (binWriter.go:163)."""
    if samcigar.is_unmapped(cigars):
        return tb.new_three_bit(np.asarray(seq, np.int8), tb.A)
    parts = []
    idx = 0
    for c in cigars:
        if c.op in ("S", "X", "I"):
            parts.append(np.asarray(seq[idx:idx + c.run_length], np.int8))
        idx += c.run_length
    flat = np.concatenate(parts) if parts else np.zeros(0, np.int8)
    return tb.new_three_bit(flat, tb.A)


def _encode_qual(q) -> list[tuple[int, int]]:
    """encodeQual (binWriter.go:178): run-length (count, value) pairs."""
    out: list[tuple[int, int]] = []
    run, val = 0, int(q[0])
    for x in q:
        x = int(x)
        if x != val and run != 0:
            out.append((run, val))
            run, val = 0, x
        run += 1
    if run != 0:
        out.append((run, val))
    return out


def _note_to_bytes(n: Note) -> bytes:
    """noteToBytes (binWriter.go:205)."""
    if len(n.tag) != 2:
        raise ValueError(f"Tag is not two bytes: {n.tag}")
    out = bytearray(n.tag.encode())
    out.append(ord(n.type))
    t = n.type
    if t == "A":
        out.extend(n.value.encode())
    elif t == "c":
        out.extend(struct.pack("<b", int(n.value)))
    elif t == "C":
        out.extend(struct.pack("<B", int(n.value)))
    elif t == "s":
        out.extend(struct.pack("<h", int(n.value)))
    elif t == "S":
        out.extend(struct.pack("<H", int(n.value)))
    elif t == "i":
        out.extend(struct.pack("<i", int(n.value)))
    elif t == "I":
        out.extend(struct.pack("<I", int(n.value)))
    elif t == "f":
        # the reference truncates to uint32 (binWriter.go:255)
        out.extend(struct.pack("<I", int(float(n.value))))
    elif t in ("Z", "H", "B"):
        out.extend(n.value.encode())
        if not out.endswith(b"\x00"):
            out.append(0)
    else:
        raise ValueError(f"Unrecognized tag type: {t}")
    return bytes(out)


def encode_giraf(g: Giraf) -> bytes:
    """WriteGiraf's buffer body including the leading blockSize
    (binWriter.go:61-160)."""
    fancy = _get_fancy_seq(g.seq, g.cigar)
    qual = _encode_qual(g.qual)
    notes = b"".join(_note_to_bytes(n) for n in g.notes)
    qname = g.qname.encode()
    if len(qname) > 255:
        raise ValueError("Read name exceeds 256 characters")
    size = (33 + len(qname) + 4 * len(g.path.nodes) + 3 * len(g.cigar)
            + 8 * len(fancy.seq) + 3 * len(qual) + len(notes))
    buf = bytearray()
    buf.extend(struct.pack("<I", size))
    buf.append(len(qname))
    buf.extend(qname)
    buf.append(g.flag & 0xFF)
    buf.extend(struct.pack("<II", g.path.t_start, g.path.t_end))
    buf.extend(struct.pack("<I", len(g.path.nodes)))
    for v in g.path.nodes:
        buf.extend(struct.pack("<I", v))
    buf.extend(struct.pack("<I", len(g.cigar)))
    for c in g.cigar:
        buf.extend(struct.pack("<H", c.run_length))
        buf.append(ord(c.op))
    buf.extend(struct.pack("<I", fancy.len))
    for w in fancy.seq:
        buf.extend(struct.pack("<Q", int(w)))
    buf.extend(struct.pack("<q", g.aln_score))
    buf.append(g.mapq & 0xFF)
    buf.extend(struct.pack("<H", len(qual)))
    for run, val in qual:
        buf.extend(struct.pack("<H", run))
        buf.append(val)
    buf.extend(notes)
    return bytes(buf)


def compress_giraf(infilename: str, outfilename: str) -> None:
    """binaryGiraf.CompressGiraf (binWriter.go:35)."""
    with open(outfilename, "wb") as fh:
        w = BgzfWriter(fh)
        for g in girafio.read(infilename):
            w.write(encode_giraf(g))
        w.close()


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def next(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.next(1)[0]

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals


def _add_full_seq(g: Giraf, fancy: tb.ThreeBit, graph) -> None:
    """addFullSeq (binReader.go:178): reconstruct the read from graph
    nodes ('=' ops) and the fancy bases (S/X/I ops)."""
    fancy_bases = tb.to_dna_bases(fancy) if fancy.len else \
        np.zeros(0, np.int8)
    parts = []
    ref_idx = g.path.t_start
    node_i = 0
    node = graph.nodes[g.path.nodes[0]] if g.path.nodes else None
    fpos = 0
    for c in g.cigar:
        if c.op == "=":
            for _ in range(c.run_length):
                if ref_idx > len(node.seq) - 1:
                    ref_idx = 0
                    node_i += 1
                    node = graph.nodes[g.path.nodes[node_i]]
                parts.append(np.asarray(node.seq[ref_idx:ref_idx + 1],
                                        np.int8))
                ref_idx += 1
        elif c.op in ("X", "S", "I"):
            parts.append(fancy_bases[fpos:fpos + c.run_length])
            fpos += c.run_length
            if c.op == "X":
                ref_idx += c.run_length
        elif c.op == "D":
            ref_idx += c.run_length
        else:
            raise ValueError(f"Unrecognized cigar operation: {c.op}")
    g.seq = np.concatenate(parts) if parts else np.zeros(0, np.int8)


def _q_start_end(g: Giraf) -> tuple[int, int]:
    """determineQStartQEnd (binReader.go:280-299): end is the index of
    the last aligned base (len(seq)-1), not one-past-the-end."""
    if samcigar.is_unmapped(g.cigar):
        return 0, 0
    start = g.cigar[0].run_length if g.cigar[0].op == "S" else 0
    end = len(g.seq) - 1
    if g.cigar[-1].op == "S":
        end -= g.cigar[-1].run_length
    return start, end


def _read_notes(g: Giraf, c: _Cursor, limit: int) -> None:
    """appendNotes (binReader.go:225)."""
    while c.pos < limit:
        tag = c.next(2).decode()
        typ = chr(c.u8())
        if typ == "A":
            value = chr(c.u8())
        elif typ == "c":
            value = str(c.take("b")[0])
        elif typ == "C":
            value = str(c.take("B")[0])
        elif typ == "s":
            value = str(c.take("h")[0])
        elif typ == "S":
            value = str(c.take("H")[0])
        elif typ == "i":
            value = str(c.take("i")[0])
        elif typ == "I":
            value = str(c.take("I")[0])
        elif typ == "f":
            value = f"{float(c.take('I')[0]):f}"
        elif typ in ("Z", "H", "B"):
            raw = bytearray()
            b = c.u8()
            while b != 0:
                raw.append(b)
                b = c.u8()
            value = raw.decode()
        else:
            raise ValueError(f"Unrecognized tag type: {typ}")
        g.notes.append(Note(tag=tag, type=typ, value=value))


def read_giraf_records(filename: str, graph) -> list[Giraf]:
    """ReadGiraf loop (binReader.go:64): decode every record; seq
    reconstructed from the graph."""
    with gzip.open(filename, "rb") as f:  # bgzf is multi-member gzip
        data = f.read()
    c = _Cursor(data)
    out: list[Giraf] = []
    while c.pos + 4 <= len(data):
        (block_size,) = c.take("I")
        end = c.pos + block_size
        g = Giraf()
        qlen = c.u8()
        g.qname = c.next(qlen).decode()
        g.flag = c.u8()
        g.path.t_start, g.path.t_end = c.take("II")
        (path_len,) = c.take("I")
        g.path.nodes = list(c.take(f"{path_len}I")) if path_len else []
        (n_cig,) = c.take("I")
        for _ in range(n_cig):
            run, = c.take("H")
            g.cigar.append(samcigar.CigarOp(run, chr(c.u8())))
        (fancy_len,) = c.take("I")
        n_words = (fancy_len + 20) // 21
        fancy = tb.ThreeBit(
            seq=np.array(c.take(f"{n_words}Q"), np.uint64)
            if n_words else np.zeros(0, np.uint64),
            len=fancy_len)
        _add_full_seq(g, fancy, graph)
        (g.aln_score,) = c.take("q")
        g.mapq = c.u8()
        (n_qual,) = c.take("H")
        quals = []
        for _ in range(n_qual):
            run, = c.take("H")
            quals.extend([c.u8()] * run)
        g.qual = np.asarray(quals, np.uint8)
        g.q_start, g.q_end = _q_start_end(g)
        _read_notes(g, c, end)
        # the reference sets PosStrand from IsForwardRead (giraf flag bit
        # 8; binReader.go:172, flag.go:24)
        g.pos_strand = bool(g.flag & 8)
        out.append(g)
    return out


def decompress_giraf(infilename: str, outfilename: str, graph) -> None:
    """binaryGiraf.DecompressGiraf (binReader.go:37)."""
    girafio.write(outfilename, read_giraf_records(infilename, graph))
