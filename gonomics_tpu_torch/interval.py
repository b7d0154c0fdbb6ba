"""Interval queries over bed and VCF records, as ``intervalOverlap``
makes them: a copy of ``gonomics_tpu/interval.py`` (the relationships
:27-37, the spans :40-53, ``transform`` :56, the fractional-cascading
range tree :81-201, ``IntervalIndex`` :204, ``merge_intervals`` :242,
``overlap_size`` :263, ``interval_size`` :270, ``read_intervals`` :274,
``record_to_string`` :284).

Each Allen relationship is a box query on the points (start, end - 1)
(``transform``), answered by a static range tree a chromosome with
fractional cascading, walked literally as gonomics' interval package
walks it, so that a query's hits come in the same order.
"""

from __future__ import annotations

import bisect

from .io import bed as bedio
from .io import vcf as vcfio

X_MIN = 0.0
X_MAX = 10_000_000_000.0

RELATIONSHIPS = ["o", "oi", "d", "di", "m", "mi", "s", "si", "f", "fi",
                 "lt", "gt", "e", "any", "within", "start", "end", "equal"]

_ANY = ["o", "oi", "d", "di", "m", "mi", "s", "si", "f", "fi", "e"]
_COMPOUND = {
    "any": _ANY,
    "within": ["d", "s", "f", "e"],
    "start": ["s", "si", "e"],
    "end": ["f", "fi", "e"],
    "equal": ["e"],
}


def chrom_start(rec) -> int:
    if isinstance(rec, vcfio.Vcf):
        return rec.pos - 1 if len(rec.ref) == 1 else rec.pos
    return rec.chrom_start


def chrom_end(rec) -> int:
    if isinstance(rec, vcfio.Vcf):
        return rec.pos if len(rec.ref) == 1 else rec.pos + len(rec.ref) - 1
    return rec.chrom_end


def chrom_of(rec) -> str:
    return rec.chrom


def transform(q_start: int, q_end: int, op: str):
    """relationship.go:40 transform — box bounds (x1,x2,y1,y2)."""
    x = float(q_start)
    y = float(q_end - 1)
    T = {
        "o": (X_MIN, x - 0.5, x + 0.5, y - 0.5),
        "oi": (x + 0.5, y - 0.5, y + 0.5, X_MAX),
        "d": (x + 0.5, y - 0.5, x + 0.5, y - 0.5),
        "di": (X_MIN, x - 0.5, y + 0.5, X_MAX),
        "m": (X_MIN, x, x, x),
        "mi": (y, y, y, X_MAX),
        "s": (x, x, x, y - 0.5),
        "si": (x, x, y + 0.5, X_MAX),
        "f": (x + 0.5, y, y, y),
        "fi": (X_MIN, x - 0.5, y, y),
        "lt": (X_MIN, x - 0.5, X_MIN, x - 0.5),
        "gt": (y + 0.5, X_MAX, y + 0.5, X_MAX),
        "e": (x, x, y, y),
    }
    if op not in T:
        raise ValueError(f"Invalid relationship: {op}")
    x1, x2, y1, y2 = T[op]
    return x1, x2, y1, y2


class _Node:
    """Range-tree node with fractional cascading (interval.go:24)."""

    __slots__ = ("val", "data", "x_mid", "i_left", "i_right", "l", "r")

    def __init__(self):
        self.val = None
        self.data = []
        self.x_mid = 0
        self.i_left = self.i_right = None
        self.l = self.r = None


def _y(rec) -> int:
    return chrom_end(rec) - 1


def _create_fc_index(large: list, small: list) -> list[int]:
    """createFCIndex (interval.go:50)."""
    answer = [0] * len(large)
    si = 0
    i = 0
    while i < len(large):
        if si > len(small) - 1:
            answer[i] = -1
            i += 1
            continue
        if _y(large[i]) <= _y(small[si]):
            answer[i] = si
            i += 1
        else:
            si += 1
    return answer


def _build_tree(intervals: list) -> _Node:
    """buildTree (interval.go:92): intervals arrive y-sorted."""
    node = _Node()
    p = sorted(intervals, key=chrom_start)
    node.data = list(intervals)
    if len(p) == 1:
        node.val = p[0]
        return node
    mid = (len(p) - 1) // 2
    p_left = sorted(p[:mid + 1], key=_y)
    p_right = sorted(p[mid + 1:], key=_y)
    node.x_mid = chrom_start(p[mid])
    node.i_left = _create_fc_index(node.data, p_left)
    node.i_right = _create_fc_index(node.data, p_right)
    node.l = _build_tree(p_left)
    node.r = _build_tree(p_right)
    return node


def _find_split(x1: float, x2: float, node: _Node) -> _Node:
    while node.val is None:
        if node.x_mid < x1:
            node = node.r
        elif x2 < node.x_mid:
            node = node.l
        else:
            return node
    return node


def _within_range(rec, op: str, x1, x2, y1, y2) -> bool:
    q1, q2 = float(chrom_start(rec)), float(_y(rec))
    if op in ("m", "mi") and q1 == q2:
        return False
    return x1 <= q1 <= x2 and y1 <= q2 <= y2


def _fc_query(tree: _Node, q, op: str) -> list:
    """The hits of q under op, in the order of gonomics' tree walk."""
    x1, x2, y1, y2 = transform(chrom_start(q), chrom_end(q), op)
    answer: list = []
    split = _find_split(x1, x2, tree)
    if split.val is not None:
        if _within_range(split.val, op, x1, x2, y1, y2):
            answer.append(split.val)
        return answer
    ys = [_y(r) for r in split.data]
    i = bisect.bisect_left(ys, y1)
    ri = i
    if i >= len(split.data):
        return []

    def emit(rec):
        if op in ("m", "mi") and chrom_start(rec) == _y(rec):
            return
        answer.append(rec)

    v, i = split.l, split.i_left[i]
    while v.val is None and i != -1:
        if x1 <= v.x_mid:
            j = v.i_right[i]
            while j != -1 and j < len(v.r.data) and _y(v.r.data[j]) <= y2:
                emit(v.r.data[j])
                j += 1
            i, v = v.i_left[i], v.l
        else:
            i, v = v.i_right[i], v.r
    if v.val is not None and _within_range(v.val, op, x1, x2, y1, y2):
        answer.append(v.val)

    v, i = split.r, split.i_right[ri]
    while v.val is None and i != -1:
        if x2 >= v.x_mid:
            j = v.i_left[i]
            while j != -1 and j < len(v.l.data) and _y(v.l.data[j]) <= y2:
                emit(v.l.data[j])
                j += 1
            i, v = v.i_right[i], v.r
        else:
            i, v = v.i_left[i], v.l
    if v.val is not None and _within_range(v.val, op, x1, x2, y1, y2):
        answer.append(v.val)
    return answer


class IntervalIndex:
    """interval.BuildTree analog: per-chromosome fractional-cascading
    range trees with reference-identical query result ordering."""

    def __init__(self, records):
        self.by_chrom: dict[str, _Node] = {}
        groups: dict[str, list] = {}
        for r in records:
            groups.setdefault(chrom_of(r), []).append(r)
        for chrom, recs in groups.items():
            recs.sort(key=_y)
            self.by_chrom[chrom] = _build_tree(recs)

    def query_one(self, q, op: str) -> list:
        tree = self.by_chrom.get(chrom_of(q))
        if tree is None:
            return []
        return _fc_query(tree, q, op)

    def query(self, q, relationship: str) -> list:
        """interval.Query (interval.go:157): compound relationships are
        unions in the reference's fixed order; single-base queries are
        deduplicated."""
        ops = _COMPOUND.get(relationship, [relationship])
        answer: list = []
        for op in ops:
            answer.extend(self.query_one(q, op))
        if len(answer) > 1 and chrom_end(q) - chrom_start(q) == 1:
            seen = set()
            dedup = []
            for a in answer:
                if id(a) not in seen:
                    seen.add(id(a))
                    dedup.append(a)
            answer = dedup
        return answer


def merge_intervals(records: list) -> list:
    """interval.MergeIntervals (aggregate.go:21): overlapping records
    collapse to plain bed spans."""
    out = []
    by_chrom: dict[str, list] = {}
    for r in records:
        by_chrom.setdefault(chrom_of(r), []).append(r)
    for chrom in by_chrom:
        recs = sorted(by_chrom[chrom],
                      key=lambda r: (chrom_start(r), chrom_end(r)))
        cur_s, cur_e = chrom_start(recs[0]), chrom_end(recs[0])
        for r in recs[1:]:
            if chrom_start(r) < cur_e:
                cur_e = max(cur_e, chrom_end(r))
            else:
                out.append(bedio.Bed(chrom, cur_s, cur_e))
                cur_s, cur_e = chrom_start(r), chrom_end(r)
        out.append(bedio.Bed(chrom, cur_s, cur_e))
    return out


def overlap_size(a, b) -> int:
    if chrom_of(a) != chrom_of(b):
        return 0
    return max(0, min(chrom_end(a), chrom_end(b))
               - max(chrom_start(a), chrom_start(b)))


def interval_size(a) -> int:
    return chrom_end(a) - chrom_start(a)


def read_intervals(filename: str) -> list:
    """interval.GoReadToChan: dispatch on extension (bed/vcf supported)."""
    base = filename[:-3] if filename.endswith(".gz") else filename
    if base.endswith(".bed"):
        return bedio.read(filename)
    if base.endswith(".vcf"):
        return vcfio.read(filename)[0]
    raise ValueError(f"unsupported interval file type: {filename}")


def record_to_string(rec) -> str:
    return rec.to_string()
