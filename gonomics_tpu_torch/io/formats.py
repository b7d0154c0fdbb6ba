"""Chain, axt, PSL, genePred, MAF and GTF records with their readers
and writers: a copy of ``gonomics_tpu/io/formats.py`` (699 lines,
whole), gonomics' axt, chain, psl, genePred, maf and gtf packages.

- axt (:22-336): ``gsw ggtools``, mergesort, axTools and axtSam read,
  write, swap and convert it (``axt_to_vcf``, ``axt_to_sam``,
  ``axt_percent_identity_in_interval``);
- chain (:343-445): its reader and writer, ``chain_to_axt`` and the
  liftover of a target position (``t_pos_to_q_pos``);
- PSL and genePred (:447-554): simulateEvol's genic model and simRecon's
  accuracy read genePred; ``read_psl`` skips a line that starts with a
  letter or '-' and one of fewer than 21 fields; ``read_gene_pred``
  reads ``exon_frames`` only from an 11th column; both writers end each
  list with ',';
- MAF and GTF (:556-699): readers of their own, separate from
  ``io/maf.py`` and ``io/gtf.py`` as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna, fileio
from . import cigar as samcigar
from . import sam as samio
from . import vcf as vcfio


@dataclass
class Axt:
    r_name: str = ""
    r_start: int = 0
    r_end: int = 0
    q_name: str = ""
    q_start: int = 0
    q_end: int = 0
    q_strand_pos: bool = True
    score: int = 0
    r_seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    q_seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))

    # the interval protocol: the target's 0-based half-open span
    @property
    def chrom(self) -> str:
        return self.r_name

    @property
    def chrom_start(self) -> int:
        return self.r_start - 1

    @property
    def chrom_end(self) -> int:
        return self.r_end


def read_axt_with_header(filename: str) -> tuple[list[Axt], list[str]]:
    """The blocks of an axt file and its '#' lines, in file order
    (formats.py:48-57)."""
    with fileio.easy_open(filename) as f:
        raw = [ln.rstrip("\n") for ln in f]
    header = [ln for ln in raw if ln.startswith("#")]
    lines = [ln for ln in raw if not ln.startswith("#")]
    return _parse_axt_lines(lines), header


def read_axt(filename: str) -> list[Axt]:
    """The blocks of an axt file; '#' lines are skipped."""
    return read_axt_with_header(filename)[0]


def _parse_axt_lines(lines: list[str]) -> list[Axt]:
    out: list[Axt] = []
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        w = lines[i].split(" ")
        out.append(Axt(r_name=w[1], r_start=int(w[2]), r_end=int(w[3]),
                       q_name=w[4], q_start=int(w[5]), q_end=int(w[6]),
                       q_strand_pos=w[7] == "+", score=int(w[8]),
                       r_seq=dna.from_string(lines[i + 1]),
                       q_seq=dna.from_string(lines[i + 2])))
        i += 3
    return out


def axt_to_string(a: Axt, aln_id: int) -> str:
    """A block's three lines and the blank line after them."""
    strand = "+" if a.q_strand_pos else "-"
    return (f"{aln_id} {a.r_name} {a.r_start} {a.r_end} {a.q_name} "
            f"{a.q_start} {a.q_end} {strand} {a.score}\n"
            f"{dna.to_string(a.r_seq)}\n{dna.to_string(a.q_seq)}\n\n")


def write_axt(filename: str, records: list[Axt]) -> None:
    """The blocks numbered from 0 in list order (formats.py:90-93)."""
    with fileio.easy_create(filename) as f:
        for i, a in enumerate(records):
            f.write(axt_to_string(a, i))


def swap_axt(a: Axt, t_len: int, q_len: int) -> None:
    """In place, the target and query names and coordinates exchanged,
    minus-strand coordinates flipped onto the other strand
    (formats.py:96-110). Its two row swaps cancel, so the rows stay
    where they were; on a minus strand both are reverse-complemented."""
    a.r_seq, a.q_seq = a.q_seq, a.r_seq
    a.r_name, a.q_name = a.q_name, a.r_name
    if not a.q_strand_pos:
        r_start, r_end = q_len - a.q_end + 1, q_len - a.q_start + 1
        q_start, q_end = t_len - a.r_end + 1, t_len - a.r_start + 1
        a.r_start, a.r_end, a.q_start, a.q_end = r_start, r_end, q_start, q_end
        a.r_seq = dna.reverse_complement(a.r_seq)
        a.q_seq = dna.reverse_complement(a.q_seq)
    else:
        a.r_start, a.r_end, a.q_start, a.q_end = \
            a.q_start, a.q_end, a.r_start, a.r_end
    a.r_seq, a.q_seq = a.q_seq, a.r_seq


def pair_seq_to_cigar(a: np.ndarray, b: np.ndarray) -> list[samcigar.CigarOp]:
    """=/X/I/D runs of a gapped pair: a gap in a is I, a gap in b is D; a
    gap against a gap raises ValueError (formats.py:113-144)."""
    a, b = np.asarray(a), np.asarray(b)
    out: list[samcigar.CigarOp] = []
    i = 0
    while i < len(a):
        if a[i] != dna.GAP and b[i] != dna.GAP:
            op = "=" if a[i] == b[i] else "X"
        elif a[i] == dna.GAP and b[i] != dna.GAP:
            op = "I"
        elif a[i] != dna.GAP and b[i] == dna.GAP:
            op = "D"
        else:
            raise ValueError("gap aligned to gap")
        j = i + 1
        while j < len(a):
            if op == "=" and not (a[j] == b[j] and a[j] != dna.GAP):
                break
            if op == "X" and not (a[j] != b[j] and a[j] != dna.GAP
                                  and b[j] != dna.GAP):
                break
            if op == "I" and a[j] != dna.GAP:
                break
            if op == "D" and b[j] != dna.GAP:
                break
            j += 1
        out.append(samcigar.CigarOp(run_length=j - i, op=op))
        i = j
    return out


def axt_to_sam(a: Axt) -> samio.Sam:
    """One SAM record of a block (formats.py:147-156): POS the target
    start, TLEN r_end - r_start, MAPQ 255, flag 16 on a minus query, SEQ
    the query without gaps, AS:i the score, XS:i and XE:i the query
    span."""
    q = np.asarray(a.q_seq)
    return samio.Sam(
        qname=a.q_name, flag=0 if a.q_strand_pos else 16, rname=a.r_name,
        pos=a.r_start, mapq=255, cigar=pair_seq_to_cigar(a.r_seq, a.q_seq),
        rnext="*", pnext=0, tlen=a.r_end - a.r_start, seq=q[q != dna.GAP],
        qual="*", extra=f"AS:i:{a.score}\tXS:i:{a.q_start}\tXE:i:{a.q_end}")


def _axt_info(a: Axt) -> str:
    """The block's fields as the info tag gives them (Go's %t: true and
    false)."""
    strand = "true" if a.q_strand_pos else "false"
    return (f"{a.r_name};{a.r_start};{a.r_end};{a.q_name};{a.q_start};"
            f"{a.q_end};{strand};{a.score}")


def _b2s_upper(base: int) -> str:
    return dna.to_string(dna.to_upper(np.array([base], np.int8)))


def axt_to_vcf(a: Axt) -> list[vcfio.Vcf]:
    """SNP, INS and DEL records of one axt block, with the reference's
    quirks: an insertion carries SVTYPE=SNP in its info and is appended
    twice (``ggtools`` drops the copy by position), and the branches that
    rewrite info to "SVTYPE=SNP;INS" or ";DEL" compare the last record's
    info to the bare "SVTYPE=SNP", which the query=...-prefixed tags never
    equal."""
    answer: list[vcfio.Vcf] = []
    rs, qs = np.asarray(a.r_seq), np.asarray(a.q_seq)
    rs_u, qs_u = dna.to_upper(rs), dna.to_upper(qs)
    n = len(rs)
    r_count = a.r_start - 1
    q_count = a.q_start - 1
    i = 0
    while i < n:
        if rs[i] != dna.GAP and qs[i] != dna.GAP:
            r_count += 1
            q_count += 1
            if rs_u[i] != qs_u[i]:
                answer.append(vcfio.Vcf(
                    chrom=a.r_name, pos=r_count, id=a.q_name,
                    ref=_b2s_upper(rs[i]), alt=[_b2s_upper(qs[i])],
                    qual=30, filter="PASS",
                    info=f"query={q_count};SVTYPE=SNP;{_axt_info(a)}"))
        if rs[i] == dna.GAP:
            if i == 0:
                raise IndexError("axt alignment begins with a target gap")
            q_count += 1
            curr = vcfio.Vcf(
                chrom=a.r_name, pos=r_count, id=a.q_name,
                ref=_b2s_upper(rs[i - 1]), alt=[_b2s_upper(qs[i - 1])],
                qual=24, filter="PASS",
                info=f"query={q_count};SVTYPE=SNP;{_axt_info(a)}")
            j = i
            while j < n:
                if rs_u[j] == dna.GAP:
                    curr.alt[0] += _b2s_upper(qs[j])
                    q_count += 1
                    j += 1
                else:
                    if not answer:
                        answer.append(curr)
                    elif answer[-1].pos == curr.pos and \
                            answer[-1].info == "SVTYPE=SNP":
                        curr.info = "SVTYPE=SNP;INS"
                        answer[-1] = curr
                    else:
                        answer.append(curr)
                    answer.append(curr)
                    i = j - 1
                    break
        if qs[i] == dna.GAP:
            if i == 0:
                raise IndexError("axt alignment begins with a query gap")
            temp_r = 0
            curr = vcfio.Vcf(
                chrom=a.r_name, pos=r_count, id=a.q_name,
                ref=_b2s_upper(rs[i - 1]), alt=[_b2s_upper(qs[i - 1])],
                qual=24, filter="PASS",
                info=f"query={q_count};SVTYPE=DEL;{_axt_info(a)}")
            j = i
            while j < n:
                if qs_u[j] == dna.GAP:
                    curr.ref += _b2s_upper(rs[j])
                    temp_r += 1
                    j += 1
                else:
                    if not answer:
                        answer.append(curr)
                    elif answer[-1].pos == curr.pos and \
                            answer[-1].info == "SVTYPE=SNP":
                        curr.info = "SVTYPE=SNP;DEL"
                        answer[-1] = curr
                    else:
                        answer.append(curr)
                    r_count += temp_r
                    i = j - 1
                    break
        i += 1
    return answer


@dataclass
class BaseStats:
    size: int
    t_bases: int = 0
    q_bases: int = 0


@dataclass
class Chain:
    score: int = 0
    t_name: str = ""
    t_size: int = 0
    t_strand: bool = True
    t_start: int = 0
    t_end: int = 0
    q_name: str = ""
    q_size: int = 0
    q_strand: bool = True
    q_start: int = 0
    q_end: int = 0
    alignment: list[BaseStats] = field(default_factory=list)
    id: int = 0


def chain_to_axt(ch: Chain, target: np.ndarray, query: np.ndarray) -> Axt:
    """A chain's blocks expanded into the gapped axt sequences from the
    two chromosomes' sequences."""
    ans = Axt(r_name=ch.t_name, r_start=ch.t_start + 1, r_end=ch.t_end,
              q_name=ch.q_name, q_start=ch.q_start + 1, q_end=ch.q_end,
              q_strand_pos=ch.q_strand, score=ch.score)
    t = np.array(target, np.int8, copy=True)
    q = np.array(query, np.int8, copy=True)
    if not ch.t_strand and ch.q_strand:
        t = dna.reverse_complement(t).astype(np.int8)
        q = dna.reverse_complement(q).astype(np.int8)
    elif ch.t_strand and not ch.q_strand:
        q = dna.reverse_complement(q).astype(np.int8)
    elif not ch.t_strand and not ch.q_strand:
        t = dna.reverse_complement(t).astype(np.int8)
    r_parts, q_parts = [], []
    ti, qi = ch.t_start, ch.q_start
    for blk in ch.alignment:
        r_parts.append(t[ti:ti + blk.size])
        q_parts.append(q[qi:qi + blk.size])
        ti += blk.size
        qi += blk.size
        if blk.t_bases > 0:
            r_parts.append(t[ti:ti + blk.t_bases])
            q_parts.append(np.full(blk.t_bases, dna.GAP, np.int8))
            ti += blk.t_bases
        if blk.q_bases > 0:
            q_parts.append(q[qi:qi + blk.q_bases])
            r_parts.append(np.full(blk.q_bases, dna.GAP, np.int8))
            qi += blk.q_bases
    ans.r_seq = np.concatenate(r_parts) if r_parts else np.zeros(0, np.int8)
    ans.q_seq = np.concatenate(q_parts) if q_parts else np.zeros(0, np.int8)
    return ans


def is_chain_file(filename: str) -> bool:
    return filename.endswith(".chain") or filename.endswith(".chain.gz")


def is_axt_file(filename: str) -> bool:
    return filename.endswith(".axt") or filename.endswith(".axt.gz")


def _axt_ref_idx_range(a: Axt, chrom_start: int,
                       chrom_end: int) -> tuple[int, int]:
    """The alignment columns that cover a target interval
    (formats.py:301-320)."""
    r = np.asarray(a.r_seq)
    start = 0
    stop = 0
    for i in range(len(r)):
        if stop >= chrom_start - (a.r_start - 1):
            break
        if r[i] != dna.GAP:
            stop += 1
        start += 1
    end, stop = start, 0
    for i in range(start, len(r)):
        if r[i] != dna.GAP:
            stop += 1
        end += 1
        if stop >= chrom_end - chrom_start:
            break
    return start, end


def axt_percent_identity_in_interval(a: Axt, chrom_start: int,
                                     chrom_end: int) -> float:
    """Matches over aligned columns, times 100, in a target interval,
    case ignored; N against N leaves both counts, a gap against a gap
    raises ValueError (formats.py:323-336)."""
    start, end = _axt_ref_idx_range(a, chrom_start, chrom_end)
    r = dna.to_upper(np.asarray(a.r_seq)[start:end])
    q = dna.to_upper(np.asarray(a.q_seq)[start:end])
    eq = r == q
    if bool((eq & (r == dna.GAP)).any()):
        raise ValueError("Gaps aligned to each other")
    aligned_n = int((eq & (r == dna.N)).sum())
    c = int(eq.sum()) - aligned_n
    return c / (end - start - aligned_n) * 100


def read_chain(filename: str) -> tuple[list[Chain], list[str]]:
    """(chains, '#' comment lines) of a chain file."""
    comments: list[str] = []
    chains: list[Chain] = []
    cur: Chain | None = None
    with fileio.easy_open(filename) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("#"):
                comments.append(line)
                continue
            if line.startswith("chain "):
                w = line.split(" ")
                cur = Chain(score=int(w[1]), t_name=w[2], t_size=int(w[3]),
                            t_strand=w[4] == "+", t_start=int(w[5]),
                            t_end=int(w[6]), q_name=w[7], q_size=int(w[8]),
                            q_strand=w[9] == "+", q_start=int(w[10]),
                            q_end=int(w[11]), id=int(w[12]))
                chains.append(cur)
            elif line.strip() and cur is not None:
                w = line.split("\t") if "\t" in line else line.split()
                if len(w) == 1:
                    cur.alignment.append(BaseStats(int(w[0])))
                else:
                    cur.alignment.append(BaseStats(int(w[0]), int(w[1]),
                                                   int(w[2])))
    return chains, comments


def chain_to_string(c: Chain) -> str:
    """The chain's header line and its blocks, the last block its size
    alone (chain.ToString)."""
    ts = "+" if c.t_strand else "-"
    qs = "+" if c.q_strand else "-"
    s = (f"chain {c.score} {c.t_name} {c.t_size} {ts} {c.t_start} "
         f"{c.t_end} {c.q_name} {c.q_size} {qs} {c.q_start} {c.q_end} "
         f"{c.id}\n")
    for a in c.alignment[:-1]:
        s += f"{a.size}\t{a.t_bases}\t{a.q_bases}\n"
    s += f"{c.alignment[-1].size}\n"
    return s


def write_chain(filename: str, chains: list[Chain],
                comments: list[str] | None = None) -> None:
    """The comments, then each chain followed by a blank line."""
    with fileio.easy_create(filename) as f:
        for cm in comments or []:
            f.write(cm + "\n")
        for c in chains:
            f.write(chain_to_string(c) + "\n")


def t_pos_to_q_pos(c: Chain, t_pos: int) -> tuple[int, bool]:
    """The query position of target position t_pos (chain.TPosToQPos,
    lift.go:10), and False where t_pos falls in a gap (the query
    position where the gap starts) or past the last block ((0, False)).
    Raises ValueError on a minus target strand or a position outside
    the chain."""
    if not c.t_strand:
        raise ValueError("all target strands should be positive")
    curr_t = c.t_start
    curr_q = c.q_start if c.q_strand else c.q_end - 1
    if t_pos < c.t_start or t_pos > c.t_end:
        raise ValueError("TPos not within the range of the chain")
    for a in c.alignment:
        if c.q_strand:
            if curr_t + a.size > t_pos:
                return curr_q + (t_pos - curr_t), True
            curr_t += a.size
            curr_q += a.size
            if curr_t + a.t_bases > t_pos:
                return curr_q, False
            curr_t += a.t_bases
            curr_q += a.q_bases
        else:
            if curr_t + a.size > t_pos:
                return curr_q - (t_pos - curr_t), True
            curr_t += a.size
            curr_q -= a.size
            if curr_t + a.t_bases > t_pos:
                return curr_q, False
            curr_t += a.t_bases
            curr_q -= a.q_bases
    return 0, False


@dataclass
class Psl:
    match: int = 0
    mismatch: int = 0
    repeat_match: int = 0
    ns: int = 0
    q_num_ins: int = 0
    q_base_ins: int = 0
    t_num_ins: int = 0
    t_base_ins: int = 0
    strand: str = "+"
    q_name: str = ""
    q_size: int = 0
    q_start: int = 0
    q_end: int = 0
    t_name: str = ""
    t_size: int = 0
    t_start: int = 0
    t_end: int = 0
    block_count: int = 0
    block_size: list[int] = field(default_factory=list)
    q_list: list[int] = field(default_factory=list)
    t_list: list[int] = field(default_factory=list)


def _int_list(s: str) -> list[int]:
    return [int(x) for x in s.rstrip(",").split(",") if x]


def _list_text(v) -> str:
    """A list as the writers give it: comma-separated, ending in ','."""
    return ",".join(str(x) for x in v) + ","


def read_psl(filename: str) -> list[Psl]:
    """The records of a PSL file; a line that starts with a letter or
    '-' (the header) or has fewer than 21 fields is skipped."""
    out = []
    for line in fileio.read(filename):
        if not line or line[0].isalpha() or line.startswith("-"):
            continue
        w = line.split("\t")
        if len(w) < 21:
            continue
        out.append(Psl(
            match=int(w[0]), mismatch=int(w[1]), repeat_match=int(w[2]),
            ns=int(w[3]), q_num_ins=int(w[4]), q_base_ins=int(w[5]),
            t_num_ins=int(w[6]), t_base_ins=int(w[7]), strand=w[8],
            q_name=w[9], q_size=int(w[10]), q_start=int(w[11]),
            q_end=int(w[12]), t_name=w[13], t_size=int(w[14]),
            t_start=int(w[15]), t_end=int(w[16]), block_count=int(w[17]),
            block_size=_int_list(w[18]), q_list=_int_list(w[19]),
            t_list=_int_list(w[20])))
    return out


def psl_to_string(p: Psl) -> str:
    return "\t".join(str(x) for x in (
        p.match, p.mismatch, p.repeat_match, p.ns, p.q_num_ins,
        p.q_base_ins, p.t_num_ins, p.t_base_ins, p.strand, p.q_name,
        p.q_size, p.q_start, p.q_end, p.t_name, p.t_size, p.t_start,
        p.t_end, p.block_count, _list_text(p.block_size),
        _list_text(p.q_list), _list_text(p.t_list)))


@dataclass
class GenePred:
    id: str = ""
    symbol: str = ""
    chrom: str = ""
    strand: str = "+"
    tx_start: int = 0
    tx_end: int = 0
    cds_start: int = 0
    cds_end: int = 0
    exon_starts: list[int] = field(default_factory=list)
    exon_ends: list[int] = field(default_factory=list)
    exon_frames: list[int] = field(default_factory=list)
    score: int = 0


def read_gene_pred(filename: str) -> list[GenePred]:
    """The records of a genePred file; ``exon_frames`` comes only from an
    11th column and stays empty without one."""
    out = []
    for line in fileio.read(filename):
        w = line.split("\t")
        g = GenePred(id=w[0], chrom=w[1], strand=w[2], tx_start=int(w[3]),
                     tx_end=int(w[4]), cds_start=int(w[5]),
                     cds_end=int(w[6]),
                     exon_starts=_int_list(w[8]), exon_ends=_int_list(w[9]))
        if len(w) > 10:
            g.exon_frames = _int_list(w[10])
        out.append(g)
    return out


def gene_pred_to_string(g: GenePred) -> str:
    return "\t".join(str(x) for x in (
        g.id, g.chrom, g.strand, g.tx_start, g.tx_end, g.cds_start,
        g.cds_end, len(g.exon_starts), _list_text(g.exon_starts),
        _list_text(g.exon_ends), _list_text(g.exon_frames)))


@dataclass
class MafSLine:
    src: str
    start: int
    size: int
    strand: bool
    src_size: int
    seq: np.ndarray


@dataclass
class MafBlock:
    score: float = 0.0
    s_lines: list[MafSLine] = field(default_factory=list)


def read_maf(filename: str) -> list[MafBlock]:
    """The 'a' blocks of a MAF file with their 's' lines; every other
    line kind is skipped."""
    out: list[MafBlock] = []
    cur: MafBlock | None = None
    with fileio.easy_open(filename) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("#"):
                continue
            if line.startswith("a"):
                cur = MafBlock()
                for fld in line.split()[1:]:
                    if fld.startswith("score="):
                        cur.score = float(fld[6:])
                out.append(cur)
            elif line.startswith("s ") and cur is not None:
                w = line.split()
                cur.s_lines.append(MafSLine(
                    src=w[1], start=int(w[2]), size=int(w[3]),
                    strand=w[4] == "+", src_size=int(w[5]),
                    seq=dna.from_string(w[6])))
    return out


def maf_to_fasta(blocks: list[MafBlock], species_order: list[str]):
    """One record a species, its s-line sequences joined across the
    blocks (the part of a source name before its first '.' names the
    species); a block without the species gives gaps of its width."""
    from . import fasta as fastaio

    parts = {s: [] for s in species_order}
    for b in blocks:
        width = len(b.s_lines[0].seq) if b.s_lines else 0
        present = {s.src.split(".")[0]: s for s in b.s_lines}
        for sp in species_order:
            if sp in present:
                parts[sp].append(present[sp].seq)
            else:
                parts[sp].append(dna.all_gaps(width))
    return [fastaio.Fasta(sp, np.concatenate(parts[sp])
                          if parts[sp] else np.zeros(0, np.int8))
            for sp in species_order]


@dataclass
class GtfFeature:
    chrom: str
    source: str
    feature: str
    start: int
    end: int
    score: float
    strand: bool
    frame: int
    attributes: dict[str, str]


@dataclass
class Transcript:
    chrom: str = ""
    source: str = ""
    start: int = 0
    end: int = 0
    strand: bool = True
    transcript_id: str = ""
    exons: list[GtfFeature] = field(default_factory=list)
    cds: list[GtfFeature] = field(default_factory=list)


@dataclass
class Gene:
    gene_id: str = ""
    gene_name: str = ""
    transcripts: list[Transcript] = field(default_factory=list)


def _gtf_attributes(s: str) -> dict[str, str]:
    out = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(" ")
        out[k] = v.strip().strip('"')
    return out


def read_gtf(filename: str) -> dict[str, Gene]:
    """{gene_id: Gene} of a GTF file, genes and their transcripts in file
    order. A feature of a transcript not yet seen opens it; only exon
    and CDS features are kept on the transcript."""
    genes: dict[str, Gene] = {}
    tx_index: dict[str, Transcript] = {}
    for line in fileio.read(filename):
        w = line.split("\t")
        if len(w) < 9:
            continue
        feat = GtfFeature(
            chrom=w[0], source=w[1], feature=w[2], start=int(w[3]),
            end=int(w[4]), score=0.0 if w[5] == "." else float(w[5]),
            strand=w[6] == "+", frame=-1 if w[7] == "." else int(w[7]),
            attributes=_gtf_attributes(w[8]))
        gid = feat.attributes.get("gene_id", "")
        tid = feat.attributes.get("transcript_id", "")
        gene = genes.setdefault(gid, Gene(
            gene_id=gid, gene_name=feat.attributes.get("gene_name", "")))
        if feat.feature == "transcript":
            tx = Transcript(chrom=feat.chrom, source=feat.source,
                            start=feat.start, end=feat.end,
                            strand=feat.strand, transcript_id=tid)
            gene.transcripts.append(tx)
            tx_index[tid] = tx
        elif feat.feature in ("exon", "CDS", "5UTR", "3UTR",
                              "start_codon", "stop_codon"):
            tx = tx_index.get(tid)
            if tx is None:
                tx = Transcript(chrom=feat.chrom, source=feat.source,
                                start=feat.start, end=feat.end,
                                strand=feat.strand, transcript_id=tid)
                gene.transcripts.append(tx)
                tx_index[tid] = tx
            if feat.feature == "exon":
                tx.exons.append(feat)
            elif feat.feature == "CDS":
                tx.cds.append(feat)
    return genes
