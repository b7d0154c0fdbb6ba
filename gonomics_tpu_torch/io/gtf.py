"""GTF genes, transcripts and exons: reading and writing, the canonical
transcript, the per-chrom feature masks and the bed conversions; a copy
of ``gonomics_tpu/io/gtf.py`` (389 lines, whole), gonomics'
``gtf/{gtf,canon,filter,convert,arrays}.go``.

``read`` refuses a line only above 10 tab fields, with a message that
says nine; ``start_codon`` and ``stop_codon`` lines are dropped; a CDS
or UTR line binds to the first exon of its ``(transcript_id, exon_id)``
and raises KeyError where there is none; the CDS chain is reset only at
a ``transcript`` line. ``move_canonical_to_zero`` swaps a transcript
into slot 0 only where it is strictly longer (CDS, then cDNA), and
``gene_to_canonical_bed`` reorders the caller's gene by it.
``find_promoter`` builds a minus-strand window around the transcript's
start. The masks are numpy ``bool`` arrays on the host."""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from .. import fileio
from . import bed as bedio
from .chrom_info import ChromInfo


@dataclass
class Cds:
    """gtf.Cds (gtf.go:54): doubly linked along the transcript."""

    start: int
    end: int
    score: float
    frame: int
    prev: "Cds | None" = None
    next: "Cds | None" = None


@dataclass
class FiveUtr:
    start: int
    end: int
    score: float


@dataclass
class ThreeUtr:
    start: int
    end: int
    score: float


@dataclass
class Exon:
    """gtf.Exon (gtf.go:35)."""

    start: int
    end: int
    score: float
    exon_number: str = ""
    exon_id: str = ""
    cds: Cds | None = None
    five_utr: FiveUtr | None = None
    three_utr: ThreeUtr | None = None


@dataclass
class Transcript:
    """gtf.Transcript (gtf.go:24)."""

    chrom: str = ""
    source: str = ""
    start: int = 0
    end: int = 0
    score: float = -1.0
    strand: bool = True
    transcript_id: str = ""
    exons: list[Exon] = field(default_factory=list)


@dataclass
class Gene:
    """gtf.Gene (gtf.go:17). Satisfies the interval contract via the
    canonical (first) transcript like gtf/methods.go."""

    gene_id: str = ""
    gene_name: str = ""
    transcripts: list[Transcript] = field(default_factory=list)

    @property
    def chrom(self) -> str:
        return self.transcripts[0].chrom

    @property
    def chrom_start(self) -> int:
        return self.transcripts[0].start - 1

    @property
    def chrom_end(self) -> int:
        return self.transcripts[0].end


def _get_ids(attr: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in attr.split(";"):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(" ")
        out[k] = v.strip().strip('"')
    return out


def _parse_frame(s: str) -> int:
    if s == ".":
        return -1
    v = int(s)
    if v > 2 or v < 0:
        raise SystemExit("Frame for GTF entries must be either dot, 0, 1, "
                         "or 2.")
    return v


def read(filename: str) -> dict[str, Gene]:
    """gtf.Read (gtf.go:190): map of geneID -> Gene (insertion order
    preserved; the Go version iterates its map unordered)."""
    answer: dict[str, Gene] = {}
    tx_by_id: dict[str, Transcript] = {}
    exon_by_key: dict[tuple[str, str], Exon] = {}
    prev_cds: Cds | None = None
    for line in fileio.read(filename):
        w = line.split("\t")
        if len(w) > 10:
            raise SystemExit("The GTF file format is limited to nine "
                             f"fields. Line had {len(w)} fields.")
        score = -1.0 if w[5] == "." else float(w[5])
        ids = _get_ids(w[8])
        gene_id = ids.get("gene_id", "")
        tid = ids.get("transcript_id", "")
        eid = ids.get("exon_id", "")
        if w[2] == "transcript":
            prev_cds = None
            tx = Transcript(chrom=w[0], source=w[1], start=int(w[3]),
                            end=int(w[4]), score=score,
                            strand=w[6] == "+", transcript_id=tid)
            gene = answer.setdefault(
                gene_id, Gene(gene_id=gene_id,
                              gene_name=ids.get("gene_name", "")))
            gene.transcripts.append(tx)
            tx_by_id[tid] = tx
        elif w[2] == "exon":
            exon = Exon(start=int(w[3]), end=int(w[4]), score=score,
                        exon_number=ids.get("exon_number", ""),
                        exon_id=eid)
            tx_by_id[tid].exons.append(exon)
            # findExon (gtf.go:120) returns the FIRST exon matching the id
            exon_by_key.setdefault((tid, eid), exon)
        elif w[2] == "CDS":
            cds = Cds(start=int(w[3]), end=int(w[4]), score=score,
                      frame=_parse_frame(w[7]), prev=prev_cds)
            if prev_cds is not None:
                prev_cds.next = cds
            prev_cds = cds
            exon_by_key[(tid, eid)].cds = cds
        elif w[2] == "5UTR":
            exon_by_key[(tid, eid)].five_utr = FiveUtr(
                int(w[3]), int(w[4]), score)
        elif w[2] == "3UTR":
            exon_by_key[(tid, eid)].three_utr = ThreeUtr(
                int(w[3]), int(w[4]), score)
        # start_codon / stop_codon lines not read (matches gtf.go:183)
    return answer


def _fmt_score(score: float) -> str:
    return "." if score == -1 else f"{score:f}"


def write_gene(f, gene: Gene) -> None:
    """gtf.WriteToFileHandle (gtf.go:219)."""
    for t in gene.transcripts:
        strand = "+" if t.strand else "-"
        f.write(f"{t.chrom}\t{t.source}\ttranscript\t{t.start}\t{t.end}\t"
                f"{_fmt_score(t.score)}\t{strand}\t.\t"
                f'gene_id "{gene.gene_id}"; transcript_id '
                f'"{t.transcript_id}"; gene_name "{gene.gene_name}";\n')
        for e in t.exons:
            att = (f'gene_id "{gene.gene_id}"; transcript_id '
                   f'"{t.transcript_id}"; exon_number "{e.exon_number}"; '
                   f'exon_id "{e.exon_id}"; gene_name '
                   f'"{gene.gene_name}";')
            f.write(f"{t.chrom}\t{t.source}\texon\t{e.start}\t{e.end}\t"
                    f"{_fmt_score(e.score)}\t{strand}\t.\t{att}\n")
            if e.five_utr is not None:
                f.write(f"{t.chrom}\t{t.source}\t5UTR\t{e.five_utr.start}"
                        f"\t{e.five_utr.end}\t{_fmt_score(e.five_utr.score)}"
                        f"\t{strand}\t.\t{att}\n")
            if e.cds is not None:
                f.write(f"{t.chrom}\t{t.source}\tCDS\t{e.cds.start}\t"
                        f"{e.cds.end}\t{_fmt_score(e.cds.score)}\t{strand}"
                        f"\t{e.cds.frame}\t{att}\n")
            if e.three_utr is not None:
                f.write(f"{t.chrom}\t{t.source}\t3UTR\t"
                        f"{e.three_utr.start}\t{e.three_utr.end}\t"
                        f"{_fmt_score(e.three_utr.score)}\t{strand}\t.\t"
                        f"{att}\n")


def write(filename: str, records: dict[str, Gene]) -> None:
    with fileio.easy_create(filename) as f:
        for gene in records.values():
            write_gene(f, gene)


# --- canon.go ---

def cdna_length(t: Transcript) -> int:
    """gtf.CdnaLength (canon.go:6)."""
    return sum(e.end - e.start + 1 for e in t.exons)


def cds_length(t: Transcript) -> int:
    """gtf.CdsLength (canon.go:15)."""
    return sum(e.cds.end - e.cds.start + 1 for e in t.exons
               if e.cds is not None)


def _is_longer(a: Transcript, b: Transcript) -> bool:
    la, lb = cds_length(a), cds_length(b)
    return la > lb or (la == lb and cdna_length(a) > cdna_length(b))


def sort_transcripts(g: Gene) -> None:
    """gtf.SortTranscripts (canon.go:32): canonical first."""
    g.transcripts.sort(key=functools.cmp_to_key(
        lambda a, b: -1 if _is_longer(a, b)
        else (1 if _is_longer(b, a) else 0)))


def move_canonical_to_zero(g: Gene) -> None:
    """gtf.MoveCanonicalToZero (canon.go:45)."""
    for i in range(1, len(g.transcripts)):
        if _is_longer(g.transcripts[i], g.transcripts[0]):
            g.transcripts[0], g.transcripts[i] = (g.transcripts[i],
                                                  g.transcripts[0])


def move_all_canonical_to_zero(m: dict[str, Gene]) -> None:
    for g in m.values():
        move_canonical_to_zero(g)


# --- arrays.go: per-chrom feature masks as numpy bool arrays ---

def _feature_mask(genes: dict[str, Gene], sizes: dict[str, ChromInfo],
                  get_span) -> dict[str, np.ndarray]:
    answer = {k: np.zeros(ci.size, dtype=bool)
              for k, ci in sizes.items()}
    for g in genes.values():
        for t in g.transcripts:
            for e in t.exons:
                span = get_span(e)
                if span is not None:
                    answer[t.chrom][span[0] - 1:span[1]] = True
    return answer


def exon_bool_array(genes, sizes):
    """gtf.ExonBoolArray (arrays.go:16)."""
    return _feature_mask(genes, sizes, lambda e: (e.start, e.end))


def cds_bool_array(genes, sizes):
    """gtf.CdsBoolArray (arrays.go:37)."""
    return _feature_mask(
        genes, sizes,
        lambda e: (e.cds.start, e.cds.end) if e.cds else None)


def five_utr_bool_array(genes, sizes):
    return _feature_mask(
        genes, sizes,
        lambda e: (e.five_utr.start, e.five_utr.end) if e.five_utr
        else None)


def three_utr_bool_array(genes, sizes):
    return _feature_mask(
        genes, sizes,
        lambda e: (e.three_utr.start, e.three_utr.end) if e.three_utr
        else None)


# --- convert.go / filter.go bed generation ---

def gene_to_promoter_bed(g: Gene, sizes: dict[str, ChromInfo],
                         upstream: int, downstream: int) -> list[bedio.Bed]:
    """gtf.GeneToPromoterBed (convert.go:71)."""
    out = []
    for t in g.transcripts:
        if t.strand:
            out.append(bedio.Bed(
                chrom=t.chrom, chrom_start=max(t.start - upstream - 1, 0),
                chrom_end=min(t.start + downstream, sizes[t.chrom].size),
                name=g.gene_name, fields_initialized=4))
        else:
            out.append(bedio.Bed(
                chrom=t.chrom, chrom_start=max(t.end - downstream - 1, 0),
                chrom_end=min(t.end + upstream, sizes[t.chrom].size),
                name=g.gene_name, fields_initialized=4))
    return out


def genes_to_tss_bed(genes: dict[str, Gene], sizes: dict[str, ChromInfo],
                     merge: bool) -> list[bedio.Bed]:
    """gtf.GenesToTssBed (convert.go:15)."""
    answer: list[bedio.Bed] = []
    for g in genes.values():
        answer.extend(gene_to_promoter_bed(g, sizes, 0, 0))
    if merge:
        bedio.sort_by_coord(answer)
        answer = bedio.merge_high_mem(answer)
    return answer


def gene_to_canonical_bed(g: Gene, sizes: dict[str, ChromInfo],
                          upstream: int, downstream: int) -> bedio.Bed:
    """gtf.GeneToCanonicalBed (convert.go:59)."""
    move_canonical_to_zero(g)
    t = g.transcripts[0]
    if t.strand:
        return bedio.Bed(chrom=t.chrom,
                         chrom_start=max(t.start - upstream - 1, 0),
                         chrom_end=min(t.start + downstream,
                                       sizes[t.chrom].size),
                         name=g.gene_name, fields_initialized=4)
    return bedio.Bed(chrom=t.chrom,
                     chrom_start=max(t.end - downstream - 1, 0),
                     chrom_end=min(t.end + upstream, sizes[t.chrom].size),
                     name=g.gene_name, fields_initialized=4)


def genes_to_canonical_transcripts_tss_bed(
        genes: dict[str, Gene],
        sizes: dict[str, ChromInfo]) -> list[bedio.Bed]:
    """gtf.GenesToCanonicalTranscriptsTssBed (convert.go:33): TSS of the
    canonical (longest-CDS) transcript per gene."""
    return [gene_to_canonical_bed(g, sizes, 0, 0) for g in genes.values()]


def genes_to_first_two_codon_bases(genes: dict[str, Gene]) \
        -> list[bedio.Bed]:
    """gtf.GenesToBedFirstTwoCodonBases (convert.go:104)."""
    answer: list[bedio.Bed] = []
    for g in genes.values():
        for t in g.transcripts:
            for e in t.exons:
                if e.cds is None:
                    continue
                pos = e.cds.start + e.cds.frame - 1
                while pos + 2 <= e.cds.end:
                    if t.strand:
                        answer.append(bedio.Bed(
                            chrom=t.chrom, chrom_start=pos,
                            chrom_end=pos + 2, fields_initialized=3))
                    else:
                        answer.append(bedio.Bed(
                            chrom=t.chrom, chrom_start=pos + 1,
                            chrom_end=pos + 3, fields_initialized=3))
                    pos += 3
    bedio.sort_by_coord(answer)
    return answer


def find_promoter(gene_names: list[str], upstream: int, downstream: int,
                  genes: dict[str, Gene],
                  sizes: dict[str, ChromInfo]) -> list[bedio.Bed]:
    """gtf.FindPromoter (filter.go:66)."""
    answer: list[bedio.Bed] = []
    for name in gene_names:
        for g in genes.values():
            if g.gene_name != name:
                continue
            for t in g.transcripts:
                if t.strand:
                    answer.append(bedio.Bed(
                        chrom=t.chrom,
                        chrom_start=max(t.start - upstream, 0),
                        chrom_end=min(t.start + downstream + 1,
                                      sizes[t.chrom].size),
                        name=name, fields_initialized=4))
                else:
                    answer.append(bedio.Bed(
                        chrom=t.chrom,
                        chrom_start=max(t.start - downstream, 0),
                        chrom_end=min(t.start + upstream + 1,
                                      sizes[t.chrom].size),
                        name=name, fields_initialized=4))
    return answer
