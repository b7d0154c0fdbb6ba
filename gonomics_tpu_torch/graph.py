"""Genome graphs: nodes of sequence joined by weighted edges. Mirrors the
parts of ``gonomics_tpu/graph.py`` that the graph aligner and the graph
tools use: the records, the .gg/.sg reader and writer (:45-96), the
topological sort (:99-147), the linear graph of a FASTA reference
(:150-158), the random giraf reads and somatic mutations of
girafSimulate (:161-318), the construction of a variant graph from VCF
records (:325-556) and the k-mer seed index (:563-615).

Nodes live in an index-addressed list (edges hold node indices) and
sequences are int8 code arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import dna, fileio
from .io import vcf as vcfio


@dataclass
class Edge:
    dest: int
    prob: float


@dataclass
class Node:
    id: int
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    prev: list[Edge] = field(default_factory=list)
    next: list[Edge] = field(default_factory=list)


@dataclass
class GenomeGraph:
    nodes: list[Node] = field(default_factory=list)


def _fmt_prob(p: float) -> str:
    """Edge weight as Go's %v prints a float32."""
    f = float(np.float32(p))
    if f == int(f):
        return str(int(f))
    return f"{f:g}"


def read(filename: str) -> GenomeGraph:
    """A .gg/.sg file: '>id' node headers, sequence lines, and edge lines
    'home\\tprob\\tdest[\\tprob\\tdest...]'."""
    g = GenomeGraph()
    seqs: dict[int, list[np.ndarray]] = {}
    cur = -1
    with fileio.easy_open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                cur = int(line[1:])
                while len(g.nodes) <= cur:
                    g.nodes.append(Node(id=len(g.nodes)))
                seqs.setdefault(cur, [])
            elif "\t" in line:
                words = line.split("\t")
                home = int(words[0])
                for i in range(1, len(words) - 1, 2):
                    add_edge(g.nodes[home], g.nodes[int(words[i + 1])],
                             float(words[i]))
            else:
                seqs[cur].append(dna.from_string(line))
    for idx, chunks in seqs.items():
        if chunks:
            g.nodes[idx].seq = np.concatenate(chunks)
    return g


def add_edge(u: Node, v: Node, prob: float) -> None:
    u.next.append(Edge(v.id, prob))
    v.prev.append(Edge(u.id, prob))


def write(filename: str, g: GenomeGraph, line_length: int = 50) -> None:
    """The .gg text that ``read`` parses."""
    with fileio.easy_create(filename) as f:
        for n in g.nodes:
            f.write(f">{n.id}\n")
            s = np.asarray(n.seq)
            for i in range(0, len(s), line_length):
                f.write(dna.to_string(s[i:i + line_length]) + "\n")
        for n in g.nodes:
            if n.next:
                f.write(str(n.id))
                for e in n.next:
                    f.write(f"\t{_fmt_prob(e.prob)}\t{e.dest}")
                f.write("\n")


def get_sort_order(g: GenomeGraph) -> list[int]:
    """Kahn's order per contiguous subgraph, each wave seeded in
    ascending node id."""
    order: list[int] = []
    visited = [False] * len(g.nodes)
    for root in g.nodes:
        if root.prev or visited[root.id]:
            continue
        members: list[int] = [root.id]
        visited[root.id] = True
        stack = [root.id]
        while stack:
            nid = stack.pop()
            for e in g.nodes[nid].next:
                if not visited[e.dest]:
                    visited[e.dest] = True
                    members.append(e.dest)
                    stack.append(e.dest)
        in_degree = {m: len(g.nodes[m].prev) for m in members}
        wave = [m for m in sorted(members) if in_degree[m] == 0]
        k = 0
        while k < len(wave):
            nid = wave[k]
            k += 1
            order.append(nid)
            del in_degree[nid]
            for e in g.nodes[nid].next:
                in_degree[e.dest] -= 1
                if in_degree[e.dest] == 0:
                    wave.append(e.dest)
    return order


def sort_graph(g: GenomeGraph) -> GenomeGraph:
    """Nodes renumbered into topological order, edges remapped."""
    order = get_sort_order(g)
    remap = {orig: new for new, orig in enumerate(order)}
    out = GenomeGraph()
    for new, orig in enumerate(order):
        n = g.nodes[orig]
        out.nodes.append(Node(
            id=new, seq=n.seq,
            prev=[Edge(remap[e.dest], e.prob) for e in n.prev],
            next=[Edge(remap[e.dest], e.prob) for e in n.next]))
    return out


def from_fasta(records) -> tuple[GenomeGraph, dict[int, str]]:
    """A linear graph of a FASTA reference: one node a record, its
    sequence upper-cased, no edges, and the node -> record-name map
    (``gonomics_tpu/graph.py:150``, the .fa path of ``gsw align``)."""
    g = GenomeGraph()
    names: dict[int, str] = {}
    for i, rec in enumerate(records):
        g.nodes.append(Node(id=i, seq=dna.to_upper(rec.seq).astype(np.int8)))
        names[i] = rec.name
    return g, names


# ---------------------------------------------------------------------------
# random giraf simulation (genomeGraph/giraf.go:15-145, randomReads.go:57-95)
# ---------------------------------------------------------------------------

def bases_in_graph(g: GenomeGraph) -> int:
    return sum(len(n.seq) for n in g.nodes)


def _rand_int_in_range(rng, x: int, y: int) -> int:
    return int(rng.float64() * (y - x)) + x


def rand_location_fast(g: GenomeGraph, total_bases: int, rng):
    """RandLocationFast (randomReads.go:57)."""
    r = _rand_int_in_range(rng, 0, total_bases)
    for i, n in enumerate(g.nodes):
        if r < len(n.seq):
            return i, r
        r -= len(n.seq)
    raise RuntimeError("trouble selecting a random location in the graph")


def rand_path_fwd(g: GenomeGraph, node_idx: int, pos: int, length: int,
                  rng):
    """RandPathFwd (randomReads.go:70): random forward walk collecting
    `length` bases; edge choices via RandIntInRange."""
    answer: list[int] = []
    node = g.nodes[node_idx]
    while len(answer) < length and pos < len(node.seq):
        answer.append(int(node.seq[pos]))
        pos += 1
    if len(answer) == length or not node.next:
        return [node_idx], pos, np.array(answer, np.int8)
    path = [node_idx]
    while True:
        edge_idx = _rand_int_in_range(rng, 0, len(node.next))
        node_idx = node.next[edge_idx].dest
        node = g.nodes[node_idx]
        path.append(node_idx)
        pos = 0
        while len(answer) < length and pos < len(node.seq):
            answer.append(int(node.seq[pos]))
            pos += 1
        if len(answer) == length or not node.next:
            return path, pos, np.array(answer, np.int8)


def _generate_diverse_quals(read_len: int, rng):
    """generateDiverseQuals (genomeGraph/giraf.go:60)."""
    prob = rng.intn(100)
    if prob == 0:
        aln_score = _rand_int_in_range(rng, 6000, 8000)
        mapq = rng.intn(5)
    elif prob < 10:
        aln_score = _rand_int_in_range(rng, 8000, 10000)
        mapq = _rand_int_in_range(rng, 5, 15)
    elif prob < 20:
        aln_score = _rand_int_in_range(rng, 10000, 15000)
        mapq = _rand_int_in_range(rng, 15, 30)
    else:
        aln_score = _rand_int_in_range(rng, 15000, 20000)
        mapq = _rand_int_in_range(rng, 30, 40)
    quals = np.zeros(read_len, np.uint8)
    for i in range(read_len):
        p = rng.intn(100)
        base = rng.intn(10)
        if p == 0:
            quals[i] = base
        elif p < 10:
            quals[i] = base + 10
        elif p < 20:
            quals[i] = base + 20
        else:
            quals[i] = base + 30
    return quals, aln_score, mapq


def rand_giraf(g: GenomeGraph, num_reads: int, read_len: int,
               rand_seed: int):
    """genomeGraph.RandGiraf (giraf.go:15)."""
    from .io.cigar import CigarOp
    from .io.giraf import Giraf, Path
    from .numbers.gorand import GoRand

    total = bases_in_graph(g)
    if read_len > total:
        raise SystemExit("Cannot request more bases than is present in "
                         "graph")
    rng = GoRand(rand_seed)
    answer = []
    while len(answer) < num_reads:
        node_idx, pos = rand_location_fast(g, total, rng)
        path, end_pos, seq = rand_path_fwd(g, node_idx, pos, read_len, rng)
        strand = rng.intn(2) == 0
        if len(seq) == read_len and not (seq == dna.N).any():
            qual, aln_score, mapq = _generate_diverse_quals(read_len, rng)
            strand_c = "+" if strand else "-"
            cur = Giraf(
                qname=f"{path[0]}_{pos + 1}_{path[-1]}_{end_pos + 1}_"
                      f"{strand_c}",
                q_start=0, q_end=read_len, pos_strand=strand,
                path=Path(t_start=pos, nodes=list(path), t_end=end_pos),
                cigar=[CigarOp(read_len, "M")], aln_score=aln_score,
                mapq=mapq, seq=seq, qual=qual)
            if not strand:
                cur.seq = dna.reverse_complement(cur.seq).astype(np.int8)
            answer.append(cur)
    return answer


def node_pos_to_read_pos(g: GenomeGraph, read, node: int, pos: int) -> int:
    """NodePosToReadPos (genomeGraph/giraf.go:146)."""
    pos_in_path = 0
    for i, nid in enumerate(read.path.nodes):
        if nid == node:
            pos_in_path = i
            break
    read_pos = sum(len(g.nodes[read.path.nodes[i]].seq)
                   for i in range(pos_in_path))
    return read_pos + pos - read.path.t_start


def rand_somatic_mutations(g: GenomeGraph, reads, num_snv: int,
                           allele_frequency: float, rand_seed: int):
    """genomeGraph.RandSomaticMutations (giraf.go:100)."""
    from .numbers.gorand import GoRand

    total = bases_in_graph(g)
    rng = GoRand(rand_seed)
    mut_nodes: list[int] = []
    mut_pos: list[int] = []
    for _ in range(num_snv):
        node_idx, pos = rand_location_fast(g, total, rng)
        mut_nodes.append(node_idx)
        mut_pos.append(pos)
        mutant = 4
        for read in reads:
            for k, nid in enumerate(read.path.nodes):
                if nid != node_idx:
                    continue
                if read.path.nodes[0] == node_idx and \
                        read.path.t_start > pos:
                    continue
                if read.path.nodes[-1] == node_idx and \
                        read.path.t_end < pos:
                    continue
                read_pos = node_pos_to_read_pos(g, read, node_idx, pos)
                if read_pos >= len(read.seq):
                    continue
                if mutant == 4:
                    base = int(read.seq[read_pos])
                    while True:
                        mutant = rng.intn(4)
                        if mutant != base:
                            break
                if rng.intn(100) / 100 <= allele_frequency:
                    read.seq[read_pos] = mutant
    return mut_nodes, mut_pos


# ---------------------------------------------------------------------------
# VCF -> variant graph
# ---------------------------------------------------------------------------


def _is_inv(v) -> bool:
    data = v.info.split(";")
    return (v.alt and v.alt[0] == "<INV>") or \
        (data and data[0] == "SVTYPE=INV")


def _is_dup(v) -> bool:
    return "SVTYPE=DUP" in v.info


def _is_cnv(v) -> bool:
    return "SVTYPE=CNV" in v.info


def _is_haplotype_block(v) -> bool:
    return ("SVTYPE=SNP;INS" in v.info or "SVTYPE=SNP;DEL" in v.info
            or "SVTYPE=HAP" in v.info)


def _get_sv_end(v) -> int:
    """The END= tag of a PBSV-style record."""
    if "END=" not in v.info:
        raise ValueError("Error: Vcf might not be from PBSV...")
    for word in v.info.split(";"):
        if "END=" in word:
            return int(word.split("END=")[1])
    return 0


class _Assembler:
    """Node and edge bookkeeping for ``_vchr_graph``. Edges out of a
    sentinel (a placeholder node with id -1) get no reciprocal ``prev``
    edge, so that the sorted graph keeps every node."""

    def __init__(self, g: GenomeGraph):
        self.g = g

    def new_sentinel(self) -> Node:
        return Node(id=-1)

    def add_node(self, node: Node) -> Node:
        if node.id != len(self.g.nodes):
            raise ValueError(f"node id {node.id} is not the next index "
                             f"{len(self.g.nodes)}")
        self.g.nodes.append(node)
        return node

    def add_edge(self, u: Node, v: Node, prob: float) -> None:
        u.next.append(Edge(v.id, prob))
        if u.id >= 0:
            v.prev.append(Edge(u.id, prob))

    def set_even_weights(self, u: Node) -> None:
        if u.next:
            w = float(np.float32(1) / np.float32(len(u.next)))
            for e in u.next:
                e.prob = w


def variant_graph(records, vcf_map: dict) -> GenomeGraph:
    """FASTA records + per-chromosome VCF records -> a variant graph
    (SNP/INS/DEL/INV/DUP/CNV/HAP nodes), topologically sorted."""
    g = GenomeGraph()
    for rec in records:
        filter_vcf = vcf_map.get(rec.name, [])
        if filter_vcf:
            filter_vcf = list(filter_vcf)
            vcfio.sort(filter_vcf)
            _vchr_graph(g, rec.name, rec.seq, filter_vcf)
        else:
            g.nodes.append(Node(id=len(g.nodes),
                                seq=np.asarray(rec.seq, np.int8)))
    return sort_graph(g)


def _vchr_graph(genome: GenomeGraph, chrom_name: str, chr_seq, vcfs_chr):
    """One chromosome's nodes and edges, in the control flow of
    ``gonomics_tpu/graph.py`` ``_vchr_graph`` (:408-556)."""
    b = _Assembler(genome)
    vcfs = list(vcfs_chr) + [vcfio.Vcf(chrom=chrom_name, pos=len(chr_seq))]
    chr_seq = dna.to_upper(np.asarray(chr_seq)).astype(np.int8)

    def by_id(e: Edge) -> Node:
        return genome.nodes[e.dest]

    curr = b.new_sentinel()
    last = b.new_sentinel()
    ref_allele = b.new_sentinel()
    alt_allele = b.new_sentinel()
    index = 0
    n = len(vcfs)
    i = 0
    while i < n - 1:
        v = vcfs[i]
        if v.chrom != chrom_name:
            raise ValueError("Error: chromosome names do not match...")
        if v.pos - index > 0:
            curr = Node(id=len(genome.nodes),
                        seq=chr_seq[index:v.pos - 1].copy())
            if len(curr.seq) == 0:
                curr = last
                # the ref allele exists from the previous record; only alt
                # alleles are created here
                if vcfio.snp(v):
                    alt_allele = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.alt[0])))
                    b.add_edge(curr, alt_allele, 0.5)
                elif vcfio.ins(v):
                    node = b.add_node(Node(
                        id=len(genome.nodes),
                        seq=dna.from_string(v.alt[0])[1:]))
                    b.add_edge(curr, node, 1)
                    index = v.pos - 1
                elif vcfio.dele(v):
                    node = b.add_node(Node(
                        id=len(genome.nodes),
                        seq=dna.from_string(v.ref)[1:]))
                    b.add_edge(curr, node, 1)
                    if "pbsv" in v.id:
                        index = min(v.pos + len(node.seq) - 1,
                                    vcfs[i + 1].pos - 1)
                    else:
                        index = v.pos + len(node.seq)
                elif _is_haplotype_block(v):
                    # the outer alt allele is deliberately not updated
                    hap_alt = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.alt[0])))
                    b.add_edge(curr, hap_alt, 1)
                    index = v.pos + len(ref_allele.seq) - 1
                last = curr
            else:
                curr = b.add_node(curr)
                if len(last.next) > 0:
                    for e in list(last.next):
                        b.add_edge(by_id(e), curr, 1)
                if i > 0 and (vcfio.snp(vcfs[i - 1])
                              or _is_haplotype_block(vcfs[i - 1])):
                    b.add_edge(alt_allele, curr, 1)
                b.add_edge(last, curr, 1)
                b.set_even_weights(last)

                if vcfio.snp(v):
                    ref_allele = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.ref)))
                    b.add_edge(curr, ref_allele, 0.5)
                    alt_allele = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.alt[0])))
                    b.add_edge(curr, alt_allele, 0.5)
                    curr = ref_allele
                    index = v.pos
                    # merge runs of adjacent SNPs
                    j = i + 1
                    while j < n - 1:
                        if vcfio.snp(vcfs[j - 1]) and vcfio.snp(vcfs[j]) \
                                and vcfs[j].pos - 1 == vcfs[j - 1].pos:
                            ref_allele.seq = np.concatenate(
                                [ref_allele.seq,
                                 dna.from_string(vcfs[j].ref)])
                            alt_allele.seq = np.concatenate(
                                [alt_allele.seq,
                                 dna.from_string(vcfs[j].alt[0])])
                            index = vcfs[j].pos
                            j += 1
                        else:
                            last = curr
                            i = j - 1
                            break
                elif vcfio.ins(v):
                    node = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.alt[0])))
                    b.add_edge(curr, node, 1)
                    index = v.pos - 1
                elif vcfio.dele(v):
                    node = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.ref)))
                    b.add_edge(curr, node, 1)
                    if "pbsv" in v.id:
                        index = min(v.pos + len(node.seq) - 1,
                                    vcfs[i + 1].pos - 1)
                    else:
                        index = v.pos + len(node.seq)
                elif _is_inv(v):
                    curr.seq = np.concatenate(
                        [curr.seq, dna.from_string(v.ref)])
                    inv_seq = dna.reverse_complement(
                        chr_seq[v.pos:_get_sv_end(v)]).astype(np.int8)
                    node = b.add_node(Node(id=len(genome.nodes),
                                           seq=inv_seq))
                    b.add_edge(curr, node, 1)
                    index = _get_sv_end(v)
                elif _is_cnv(v) or _is_dup(v):
                    curr.seq = np.concatenate(
                        [curr.seq, dna.from_string(v.ref)])
                    node = b.add_node(Node(
                        id=len(genome.nodes),
                        seq=chr_seq[v.pos:_get_sv_end(v)].copy()))
                    b.add_edge(curr, node, 1)
                    index = _get_sv_end(v)
                elif _is_haplotype_block(v):
                    ref_allele = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.ref)))
                    b.add_edge(curr, ref_allele, 1)
                    alt_allele = b.add_node(Node(
                        id=len(genome.nodes), seq=dna.from_string(v.alt[0])))
                    b.add_edge(curr, alt_allele, 1)
                    index = min(v.pos + len(ref_allele.seq) - 1,
                                vcfs[i + 1].pos - 1)
                    curr = ref_allele
                last = curr
        i += 1

    # the chromosome's tail after the last record
    last_node = b.add_node(Node(id=len(genome.nodes),
                                seq=chr_seq[index:].copy()))
    for e in list(last.next):
        b.add_edge(by_id(e), last_node, 1)
    if vcfio.snp(vcfs[n - 2]) or _is_haplotype_block(vcfs[n - 2]):
        b.add_edge(alt_allele, last_node, 1)
    b.add_edge(last, last_node, 1)
    b.set_even_weights(last)
    return genome


# ---------------------------------------------------------------------------
# k-mer seed index
# ---------------------------------------------------------------------------

def index_genome(g: GenomeGraph, seed_len: int,
                 seed_step: int) -> tuple[np.ndarray, np.ndarray]:
    """The seed index as flat arrays in insertion order: (codes uint64,
    packed int64 = node << 32 | pos). Each node contributes its k-mers at
    positions 0, step, 2 step, ... that hold no N, then, from the next
    sampled position to its end, the k-mers that cross into its
    successors (walked over edges by ``_index_cross``).

    ``gonomics_tpu/graph.py`` ``index_genome`` (:563) builds the same
    entries into a dict of lists keyed by code; these arrays are that
    dict's entries in insertion order, so a stable sort by code gives the
    same table. The sampled k-mers are computed for all nodes at once."""
    if not 2 <= seed_len <= 32:
        raise ValueError("seed length needs to be >1 and <33")
    k = seed_len
    lens = np.array([len(n.seq) for n in g.nodes], np.int64)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    concat = (np.concatenate([np.asarray(n.seq, np.int8) for n in g.nodes])
              if len(g.nodes) else np.zeros(0, np.int8))
    # sampled starts of every node: s = 0, step, ... while s + k <= len
    n_starts = np.where(lens >= k, (lens - k) // seed_step + 1, 0)
    node_of = np.repeat(np.arange(len(lens), dtype=np.int64), n_starts)
    first = np.repeat(np.cumsum(n_starts) - n_starts, n_starts)
    start = (np.arange(len(node_of), dtype=np.int64) - first) * seed_step
    gpos = off[node_of] + start
    codes = np.zeros(len(gpos), np.uint64)
    bad = np.zeros(len(concat) + 1, np.int64)
    np.cumsum(concat >= 4, out=bad[1:])
    for j in range(k):
        codes = (codes << np.uint64(2)) | \
            concat[gpos + j].astype(np.uint64) & np.uint64(3)
    ok = bad[gpos + k] == bad[gpos]
    s_node, s_pos, s_code = node_of[ok], start[ok], codes[ok]

    # boundary-crossing k-mers, walked over edges
    c_node: list[int] = []
    c_pos: list[int] = []
    c_code: list[int] = []

    def put(code: int, node_idx: int, pos: int) -> None:
        c_code.append(code)
        c_node.append(node_idx)
        c_pos.append(pos)

    for node, ns in zip(g.nodes, n_starts.tolist()):
        n = len(node.seq)
        pos = ns * seed_step
        if pos >= n or not node.next:
            continue
        seq = np.asarray(node.seq, dtype=np.int64)
        while pos < n:
            for e in node.next:
                _index_cross(g, seq[pos:], g.nodes[e.dest], node.id, pos,
                             k, put)
            pos += seed_step

    # insertion order: per node, its sampled k-mers, then its crossings
    node_all = np.concatenate([s_node, np.asarray(c_node, np.int64)])
    cross = np.concatenate([np.zeros(len(s_node), np.int64),
                            np.ones(len(c_node), np.int64)])
    rank = np.concatenate([s_pos, np.arange(len(c_node), dtype=np.int64)])
    order = np.lexsort((rank, cross, node_all))
    pos_all = np.concatenate([s_pos, np.asarray(c_pos, np.int64)])
    code_all = np.concatenate([s_code, np.asarray(c_code, np.uint64)])
    return code_all[order], ((node_all << 32) | pos_all)[order]


def _index_cross(g: GenomeGraph, prev_seq: np.ndarray, node: Node,
                 home_id: int, home_pos: int, seed_len: int, put) -> None:
    seq = np.asarray(node.seq, dtype=np.int64)
    if len(prev_seq) + len(seq) >= seed_len:
        kmer = np.concatenate([prev_seq, seq[:seed_len - len(prev_seq)]])
        if (kmer < 4).all():
            code = 0
            for b in kmer:
                code = (code << 2) | int(b)
            put(code, home_id, home_pos)
    else:
        ext = np.concatenate([prev_seq, seq])
        for e in node.next:
            _index_cross(g, ext, g.nodes[e.dest], home_id, home_pos,
                         seed_len, put)
