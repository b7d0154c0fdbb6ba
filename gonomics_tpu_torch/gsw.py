"""The host half of the graph aligner: seeds, their exact-match
extension over node edges, the recursive left/right graph traversal
whose extension DPs the card computes, pairing and SAM projection.

A trimmed copy of ``gonomics_tpu/gsw.py`` holding what the device engine
(``graph_align.GraphAligner``) uses: ``Seed``, ``mismatch_stats``,
``seed_could_be_better``, ``_append_soft_clips`` and, of ``GswAligner``,
the DP provider hooks (:248-256), the exact-match extenders (:260-330),
the seed table (:351), ``seed_tail``, ``_seed_path``, the traversals
(:597-640), the giraf flags and SAM projection (:655-702). The numpy
host DPs (``left_dynamic_aln``, ``right_dynamic_aln``) are not ported:
here a DP provider, which records jobs for the card or replays their
results, is always set while a traversal runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .align.matrices import HUMAN_CHIMP_TWO
from .graph import GenomeGraph, Node, index_genome
from .io import cigar as samcigar
from .io import sam as samio
from .io.cigar import CigarOp
from .io.fastq import qual_string
from .io.giraf import Giraf

NEG = -(2 ** 62)


@dataclass
class Seed:
    target_id: int
    target_start: int
    query_start: int
    length: int
    pos_strand: bool
    total_length: int
    next_part: "Seed | None" = None


def mismatch_stats(scores: np.ndarray):
    """(max match, min match, least severe mismatch, least change) of a
    score matrix, in the reference's loop order."""
    max_match = 0
    min_match = 0
    least_severe_mismatch = int(scores[0][1])
    for i in range(len(scores)):
        for j in range(len(scores[i])):
            v = int(scores[i][j])
            if v > max_match:
                min_match = max_match
                max_match = v
            elif v < 0 and least_severe_mismatch < v:
                least_severe_mismatch = v
    return (max_match, min_match, least_severe_mismatch,
            least_severe_mismatch - max_match)


def seed_could_be_better(seed_len: int, curr_best: int, perfect: int,
                         query_len: int, max_match: int, min_match: int,
                         least_mis: int, least_change: int) -> bool:
    """Whether a seed of seed_len bases can still beat curr_best."""
    seeds = query_len // (seed_len + 1)
    rem = query_len % (seed_len + 1)
    if (seed_len * max_match >= curr_best
            and perfect - (query_len - seed_len) * min_match >= curr_best):
        return True
    if (seed_len * seeds * max_match + seeds * least_mis >= curr_best
            and perfect - rem * min_match + seeds * least_change >= curr_best):
        return True
    if (seed_len * seeds * max_match + rem * max_match
            + (seeds + 1) * least_mis >= curr_best
            and perfect + (seeds + 1) * least_change >= curr_best):
        return True
    return False


def _reverse_route(route: list[CigarOp]) -> list[CigarOp]:
    return list(reversed(route))


def _append_soft_clips(front: int, read_len: int,
                       route: list[CigarOp]) -> list[CigarOp]:
    cur = samcigar.query_length(route)
    if front == 0 and cur >= read_len:
        return route
    out: list[CigarOp] = []
    if front > 0:
        out.append(CigarOp(front, "S"))
    if front + cur < read_len:
        out = out + route + [CigarOp(read_len - front - cur, "S")]
    return out


class GswAligner:
    """Graph, seed index and the reference's host logic around the
    extension DPs; ``_provider`` computes the DPs (``left(window,
    read_part)`` -> (score, walk-order route, i_stop, j_stop), and
    ``right`` -> (score, route, max_i, max_j))."""

    def __init__(self, graph: GenomeGraph, seed_len: int = 32,
                 step_size: int = 32, scores: np.ndarray = HUMAN_CHIMP_TWO,
                 node_names: dict[int, str] | None = None):
        self.g = graph
        self.seed_len = seed_len
        self.step_size = step_size
        self.scores = np.asarray(scores, np.int64)
        self.node_names = node_names or {}
        (self.max_match, self.min_match, self.least_mis,
         self.least_change) = mismatch_stats(self.scores)
        self._match_score = np.array(
            [int(self.scores[i][i]) for i in range(5)] + [0] * 8, np.int64)
        self._provider = None
        self._build_seed_table()

    def _dp_left(self, window: np.ndarray, read_part: np.ndarray):
        if self._provider is None:
            raise RuntimeError("no extension DP provider is set")
        return self._provider.left(window, read_part)

    def _dp_right(self, window: np.ndarray, read_part: np.ndarray):
        if self._provider is None:
            raise RuntimeError("no extension DP provider is set")
        return self._provider.right(window, read_part)

    # ---- exact-match counting ----

    def _count_right(self, node_seq: np.ndarray, ns: int, read: np.ndarray,
                     rs: int) -> int:
        L = min(len(node_seq) - ns, len(read) - rs)
        if L <= 0:
            return 0
        eq = node_seq[ns:ns + L] == read[rs:rs + L]
        return int(np.argmin(eq)) if not eq.all() else L

    def _count_left(self, node_seq: np.ndarray, ne: int, read: np.ndarray,
                    re_: int) -> int:
        """Matches extending left from inclusive positions (ne, re_)."""
        L = min(ne + 1, re_ + 1)
        if L <= 0:
            return 0
        eq = node_seq[ne - L + 1:ne + 1][::-1] == read[re_ - L + 1:re_ + 1][::-1]
        return int(np.argmin(eq)) if not eq.all() else L

    # ---- seed building over node edges ----

    def _extend_right(self, node: Node, read: np.ndarray, read_start: int,
                      node_start: int, pos_strand: bool) -> list[Seed]:
        right = self._count_right(node.seq, node_start, read, read_start)
        if right == 0:
            return []
        answer: list[Seed] = []
        if (read_start + right < len(read)
                and node_start + right == len(node.seq) and node.next):
            for e in node.next:
                for part in self._extend_right(self.g.nodes[e.dest], read,
                                               read_start + right, 0,
                                               pos_strand):
                    answer.append(Seed(node.id, node_start, read_start, right,
                                       pos_strand, right + part.total_length,
                                       part))
        if not answer:
            answer = [Seed(node.id, node_start, read_start, right, pos_strand,
                           right)]
        return answer

    def _extend_left(self, node: Node, read: np.ndarray,
                     part: Seed) -> list[Seed]:
        answer: list[Seed] = []
        if part.query_start > 0 and part.target_start == 0:
            rb = read[part.query_start - 1]
            for e in node.prev:
                prev_node = self.g.nodes[e.dest]
                if len(prev_node.seq) and prev_node.seq[-1] == rb:
                    answer.extend(self._extend_left_helper(prev_node, read,
                                                           part))
        return answer if answer else [part]

    def _extend_left_helper(self, node: Node, read: np.ndarray,
                            next_part: Seed) -> list[Seed]:
        node_pos = len(node.seq) - 1
        read_pos = next_part.query_start - 1
        left = min(read_pos + 1,
                   self._count_left(node.seq, node_pos, read, read_pos))
        curr = Seed(node.id, node_pos - (left - 1), read_pos - (left - 1),
                    left, next_part.pos_strand,
                    left + next_part.total_length, next_part)
        answer: list[Seed] = []
        if curr.query_start > 0 and curr.target_start == 0:
            rb = read[curr.query_start - 1]
            for e in node.prev:
                prev_node = self.g.nodes[e.dest]
                if len(prev_node.seq) and prev_node.seq[-1] == rb:
                    answer.extend(self._extend_left_helper(prev_node, read,
                                                           curr))
        return answer if answer else [curr]

    # ---- the seed table ----

    def _build_seed_table(self) -> None:
        """The k-mer index as a table sorted by code (ties in insertion
        order) plus the concatenated node sequences, so that a batch's
        lookups are binary searches and its exact-match extents batched
        compares."""
        codes, packed = index_genome(self.g, self.seed_len, self.step_size)
        order = np.argsort(codes, kind="stable")
        lens = np.array([len(n.seq) for n in self.g.nodes], np.int64)
        off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        self._seed_table = {
            "codes": codes[order], "packed": packed[order],
            "concat": (np.concatenate([n.seq for n in self.g.nodes])
                       if len(self.g.nodes) else np.zeros(0, np.int8)),
            "off": off[:-1], "len": lens,
            "has_next": np.array([bool(n.next) for n in self.g.nodes]),
        }

    @staticmethod
    def seed_tail(s: Seed) -> Seed:
        tail = s
        while tail.next_part is not None:
            tail = tail.next_part
        return tail

    def _seed_path(self, s: Seed) -> list[int]:
        path = [s.target_id]
        p = s.next_part
        while p is not None:
            path.append(p.target_id)
            p = p.next_part
        return path

    # ---- graph traversal around the seed ----

    def _left_traversal(self, node: Node, ref_end: int, extension: int,
                        read_part: np.ndarray,
                        prev_seq: np.ndarray | None = None):
        """Left extension over predecessors. Returns (route in walk order,
        score, target_start, query_start)."""
        if prev_seq is None:
            prev_seq = np.zeros(0, np.int8)
        take = min(len(prev_seq) + ref_end, extension) - len(prev_seq)
        window = np.concatenate([node.seq[ref_end - take:ref_end], prev_seq])
        if len(prev_seq) + ref_end >= extension or not node.prev:
            score, route, i_stop, j_stop = self._dp_left(window, read_part)
            t_start = ref_end - len(window) - len(prev_seq) + i_stop
            return route, score, t_start, j_stop
        best_score = NEG
        best = ([], NEG, 0, 0)
        for e in node.prev:
            prev_node = self.g.nodes[e.dest]
            route, sc, ts, qs = self._left_traversal(
                prev_node, len(prev_node.seq), extension, read_part, window)
            if sc > best_score:
                best_score = sc
                t_start = ref_end - len(window) - len(prev_seq) + ts
                best = (route, sc, t_start, qs)
        return _reverse_route(best[0]), best[1], best[2], best[3]

    def _right_traversal(self, node: Node, start: int, extension: int,
                         read_part: np.ndarray,
                         prev_seq: np.ndarray | None = None):
        """Right extension over successors. Returns (route, score,
        target_end, query_end)."""
        if prev_seq is None:
            prev_seq = np.zeros(0, np.int8)
        take = min(len(prev_seq) + len(node.seq) - start, extension) - len(prev_seq)
        window = np.concatenate([prev_seq, node.seq[start:start + take]])
        if len(prev_seq) + len(node.seq) - start >= extension or not node.next:
            score, route, max_i, max_j = self._dp_right(window, read_part)
            return route, score, max_i + start, max_j
        best_score = NEG
        best = ([], NEG, 0, 0)
        for e in node.next:
            route, sc, te, qe = self._right_traversal(
                self.g.nodes[e.dest], 0, extension, read_part, window)
            if sc > best_score:
                best_score = sc
                best = (route, sc, te, qe)
        return (_reverse_route(best[0]), best[1], best[2] + start, best[3])

    # ---- pairing and SAM ----

    @staticmethod
    def _giraf_flags(g: Giraf) -> int:
        ans = 0
        if g.pos_strand:
            ans += 4
        if g.aln_score < 1200:
            ans += 2
        return ans

    @staticmethod
    def _is_proper_pair(a: Giraf, b: Giraf) -> bool:
        if abs(a.path.t_start - b.path.t_start) < 10000:
            if (a.path.t_start < b.path.t_start and a.pos_strand
                    and not b.pos_strand):
                return True
            if (a.path.t_start > b.path.t_start and not a.pos_strand
                    and b.pos_strand):
                return True
        return False

    def giraf_to_sam(self, g: Giraf, paired_flag: int = 0) -> samio.Sam:
        """Linear-coordinate SAM record of a giraf: the first node of the
        path names the reference."""
        s = samio.Sam(qname=g.qname, flag=4, rname="*", pos=0, mapq=255,
                      cigar=[CigarOp(0, "*")], rnext="*", pnext=0, tlen=0,
                      seq=g.seq, qual=qual_string(g.qual),
                      extra="BZ:i:0\tGP:Z:-1\tXO:Z:~")
        if g.aln_score < 1200 or not g.path.nodes:
            s.flag = 4 + paired_flag
            return s
        node0 = g.path.nodes[0]
        s.rname = self.node_names.get(node0, str(node0))
        s.pos = g.path.t_start + 1
        s.flag = (0 if g.pos_strand else 16) + paired_flag
        s.mapq = 255
        s.cigar = [c for c in g.cigar]
        s.extra = (f"BZ:i:{g.aln_score}\t"
                   f"GP:Z:{'>'.join(str(n) for n in g.path.nodes)}\t"
                   f"XO:i:{g.path.t_start}")
        return s

    def pair_to_sam(self, a: Giraf, b: Giraf) -> tuple[samio.Sam, samio.Sam]:
        sa = self.giraf_to_sam(a, paired_flag=1 + 64)
        sb = self.giraf_to_sam(b, paired_flag=1 + 128)
        if self._is_proper_pair(a, b):
            sa.flag += 2
            sb.flag += 2
        return sa, sb
