"""Batched graph read aligner: vectorized seed waves on the host, the
extension DPs of every wave in one launch a side on the card.

The counterpart of ``TpuGswAligner`` (``gonomics_tpu/gsw_tpu.py``), named
after ``read_align.ReadAligner``:

  host (numpy and the native runtime, vectorized over the batch):
    - one batched sorted-table lookup finds every read's seeds and their
      exact-match extents (``native.graph_hits``, or the same hits in
      numpy); only seeds that cross node boundaries build ``Seed``
      objects through the reference recursion (``gsw.GswAligner``);
    - each seed's left and right extension windows are slices of its
      node wherever they do not cross a node boundary, gathered for the
      whole wave at once; the other seeds record their jobs through the
      recursive traversal;
    - wave 1 holds the best seed of every read; the seedCouldBeBetter
      bound decides most reads after it, and later waves (4x larger each
      time) carry the few that stay open.
  device (``ops/gsw_dp.py``):
    - ``GswDpBatch.start_wave``: LeftDynamicAln and RightDynamicAln of
      every job of the wave, walks and packing, one uint8 array back.
  host:
    - the seed loop replays the reference's choices with the wave's
      results; winner routes are run-length coded in one pass per wave;
      giraf records, pairing flags and SAM projection.

Output is byte-identical to ``TpuGswAligner`` and to the host engine
``gonomics_tpu.gsw.GswAligner`` (the score matrices shipped are
symmetric; for an asymmetric one the port follows the kernels'
orientation, scores[read code, genome code]).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from . import native
from .align.matrices import HUMAN_CHIMP_TWO
from .graph import GenomeGraph
from .gsw import GswAligner, Seed, _append_soft_clips, seed_could_be_better
from .io.cigar import CigarOp
from .io.fastq import FastqBig
from .io.giraf import Giraf, Note, Path
from .ops.gsw_dp import GswDpBatch, _routes_walk_order


class _Recorder:
    """DP provider that records jobs and returns dummies (pass A)."""

    def __init__(self):
        self.left_jobs: list = []
        self.right_jobs: list = []

    def left(self, window, read_part):
        self.left_jobs.append((np.asarray(window, np.int8),
                               np.asarray(read_part, np.int8)))
        return 0, [], 0, 0

    def right(self, window, read_part):
        self.right_jobs.append((np.asarray(window, np.int8),
                                np.asarray(read_part, np.int8)))
        return 0, [], 0, 0


class _Replayer:
    """DP provider that pops precomputed results in recording order."""

    def __init__(self, left_results, right_results):
        self.left_q = deque(left_results)
        self.right_q = deque(right_results)

    def left(self, window, read_part):
        return self.left_q.popleft()

    def right(self, window, read_part):
        return self.right_q.popleft()


@dataclass
class _SeedArrays:
    """Flat arrays over every seed of the batch, per-read sorted order."""

    read: np.ndarray      # (N,) read index
    strand: np.ndarray    # (N,) True = forward
    tid: np.ndarray       # (N,) head node id
    ts: np.ndarray        # (N,) head target start
    qs: np.ndarray        # (N,) head query start
    total: np.ndarray     # (N,) total length over all parts
    tail_tid: np.ndarray  # (N,) tail node id
    tail_ts: np.ndarray   # (N,) tail target start
    tail_qs: np.ndarray   # (N,) tail query start
    tail_len: np.ndarray  # (N,) tail part length
    obj: np.ndarray       # (N,) index into objs, -1 = single-part
    objs: list            # Seed objects for multi-part seeds


@dataclass
class _Win:
    """Snapshot of the best seed at the moment it won (the best-update
    block of ``align_seed_loop``, ``gonomics_tpu/gsw.py:563-575``)."""

    curr: int
    t_start: int
    t_end: int
    q_start: int
    q_end_carry: int      # st.q_end at win time (the carry-over quirk)
    strand: bool
    seed_qs: int
    seed_total: int
    path: list
    routes: tuple         # ("full",) | ("rows", lops, lr, rops, rr)
                          # | ("routes", lroute, rroute) — mid built lazily


@dataclass
class _BatchState:
    reads: list
    sa: _SeedArrays
    perfect: list         # per read (python ints: the replay hot loop)
    extension: list
    read_len: list
    seq2: np.ndarray      # (2R, Lmax) fwd/rc code rows
    css: list             # (2R) lists of match-score cumsums
    fullsum: list         # per row: whole-row match-score sum
    starts: list          # per read: (first gid, one-past-last gid)
    total_l: list         # per-seed python lists (replay hot loop)
    full_l: list
    strand_l: list
    tid_l: list
    ts_l: list
    qs_l: list
    span_l: list
    tail_end_l: list      # tail_ts + tail_len
    obj_l: list
    best_score: list
    q_end: list
    pos: list             # per read: NEXT unprocessed global seed id
    done: list
    active: list
    wave: int
    win: list = field(default_factory=list)
    pending: dict | None = None


class GraphAligner:
    """Batched graph aligner with the extension DPs on ``device`` (None
    means the card; "cpu" runs the kernels' plain versions)."""

    def __init__(self, graph: GenomeGraph, seed_len: int = 32,
                 step_size: int = 32, scores: np.ndarray = HUMAN_CHIMP_TWO,
                 node_names: dict[int, str] | None = None, device=None,
                 wave: int = 1):
        self.dp = GswDpBatch(np.asarray(scores, np.int64), -600,
                             device=device)
        self.host = GswAligner(graph, seed_len, step_size, scores,
                               node_names)
        self.wave = wave
        g = graph
        self._prev_cnt = np.array([len(n.prev) for n in g.nodes], np.int32)
        self._next_cnt = np.array([len(n.next) for n in g.nodes], np.int32)

    # ---- array seed finder (find_seeds_batch with array output) ----

    def _find_seeds_arrays(self, reads: list[FastqBig]):
        """Batched seed finding -> _SeedArrays + SEQ2 code matrix.

        Mirrors ``find_seeds_batch`` (``gonomics_tpu/gsw.py:381``) hit
        for hit (same lookups, extents and emission order); only
        boundary-crossing hits build Seed objects through the reference
        recursion."""
        al = self.host
        st = al._seed_table
        k = al.seed_len
        R = len(reads)
        Ls = np.array([len(r.seq) for r in reads], np.int64)
        Lmax = int(Ls.max()) if R else 0
        SEQ = np.full((2 * R, Lmax), 12, np.int8)
        for i, r in enumerate(reads):
            SEQ[2 * i, :Ls[i]] = r.seq
            SEQ[2 * i + 1, :Ls[i]] = r.seq_rc
        n_codes = Lmax - k + 1
        empty = _SeedArrays(*([np.zeros(0, np.int64)] * 10),
                            np.full(0, -1, np.int64), [])
        if n_codes <= 0 or len(st["codes"]) == 0:
            return empty, SEQ, Ls
        row_len = np.repeat(Ls, 2)
        hits = native.graph_hits(
            SEQ, row_len, k, st["codes"], st["packed"], st["concat"],
            st["off"], st["len"], st["has_next"].astype(np.uint8),
            self._prev_cnt)
        if hits is not None:
            if len(hits) == 0:
                return empty, SEQ, Ls
            rows_h = hits[:, 0]
            node_idx = hits[:, 2]
            rs0 = hits[:, 3]
            np0 = hits[:, 4]
            right_run = hits[:, 5]
            cross_right = hits[:, 6].astype(bool)
            maybe_left = hits[:, 7].astype(bool)
            strand_pos = rows_h % 2 == 0
        else:
            # numpy fallback: same hits, same order
            S64 = SEQ.astype(np.int64)
            lt4 = S64 < 4
            valid = np.lib.stride_tricks.sliding_window_view(
                lt4, k, axis=1).all(axis=2)
            vals = np.where(lt4, S64, 0).astype(np.uint64)
            codes = np.zeros((2 * R, n_codes), np.uint64)
            for i in range(k):
                codes |= vals[:, i:n_codes + i] << np.uint64(2 * (k - 1 - i))
            valid &= np.arange(n_codes)[None, :] <= (row_len[:, None] - k)
            rows, rss = np.nonzero(valid)  # row-major == scalar order
            q = codes[rows, rss]
            lo = np.searchsorted(st["codes"], q, side="left")
            hi = np.searchsorted(st["codes"], q, side="right")
            cnt = hi - lo
            m = cnt > 0
            rows_h = np.repeat(rows[m], cnt[m])
            rs_h = np.repeat(rss[m], cnt[m])
            l0, c0 = lo[m], cnt[m]
            base = np.repeat(l0, c0)
            offs = np.arange(len(base)) - np.repeat(np.cumsum(c0) - c0, c0)
            pk = st["packed"][base + offs]
            node_idx = (pk >> 32).astype(np.int64)
            node_pos = (pk & 0xFFFFFFFF).astype(np.int64)
            if len(pk) == 0:
                return empty, SEQ, Ls
            concat, noffs, nlens = st["concat"], st["off"], st["len"]
            t = np.arange(Lmax)
            noff = noffs[node_idx]
            nlen = nlens[node_idx]
            lt_lim = np.minimum(node_pos + 1, rs_h + 1)
            gi = (noff + node_pos)[:, None] - t[None, :]
            ri = rs_h[:, None] - t[None, :]
            eql = ((concat[np.clip(gi, 0, len(concat) - 1)]
                    == SEQ[rows_h[:, None], np.clip(ri, 0, Lmax - 1)])
                   & (t[None, :] < lt_lim[:, None]))
            neq = ~eql
            left_run = np.where(neq.any(axis=1), neq.argmax(axis=1), lt_lim)
            rs0 = rs_h - (left_run - 1)
            np0 = node_pos - (left_run - 1)
            rt_lim = np.minimum(nlen - np0, row_len[rows_h] - rs0)
            gi2 = (noff + np0)[:, None] + t[None, :]
            ri2 = rs0[:, None] + t[None, :]
            eqr = ((concat[np.clip(gi2, 0, len(concat) - 1)]
                    == SEQ[rows_h[:, None], np.clip(ri2, 0, Lmax - 1)])
                   & (t[None, :] < rt_lim[:, None]))
            neqr = ~eqr
            right_run = np.where(neqr.any(axis=1), neqr.argmax(axis=1),
                                 rt_lim)
            cross_right = ((rs0 + right_run < row_len[rows_h])
                           & (np0 + right_run == nlen)
                           & st["has_next"][node_idx])
            strand_pos = rows_h % 2 == 0
            # hits the reference recursion might extend over node edges:
            # rightward continuation, or leftward from a node start with
            # a predecessor (gsw._extend_left's base-match gate runs
            # inside the fallback)
            maybe_left = (strand_pos & (rs0 > 0) & (np0 == 0)
                          & (self._prev_cnt[node_idx] > 0))
        complex_h = cross_right | maybe_left
        ri_read = rows_h // 2

        simple = ~complex_h
        PARTBITS = 20
        s_key = np.nonzero(simple)[0].astype(np.int64) << PARTBITS
        f = {
            "read": ri_read[simple], "strand": strand_pos[simple],
            "tid": node_idx[simple], "ts": np0[simple], "qs": rs0[simple],
            "total": right_run[simple],
        }
        # tails == heads for single-part seeds
        f["tail_tid"], f["tail_ts"] = f["tid"], f["ts"]
        f["tail_qs"], f["tail_len"] = f["qs"], f["total"]
        f["obj"] = np.full(len(s_key), -1, np.int64)

        objs: list[Seed] = []
        c_rows: list[tuple] = []
        c_key: list[int] = []
        for h in np.nonzero(complex_h)[0].tolist():
            strand = bool(strand_pos[h])
            read = reads[ri_read[h]]
            seq = read.seq if strand else read.seq_rc
            node = al.g.nodes[node_idx[h]]
            if cross_right[h]:
                parts = al._extend_right(node, seq, int(rs0[h]),
                                         int(np0[h]), strand)
            else:
                parts = [Seed(int(node_idx[h]), int(np0[h]), int(rs0[h]),
                              int(right_run[h]), strand,
                              int(right_run[h]))]
            if strand and maybe_left[h]:
                out_seeds: list[Seed] = []
                for p in parts:
                    out_seeds.extend(al._extend_left(node, seq, p))
            else:
                out_seeds = parts
            for pi, s in enumerate(out_seeds):
                tail = al.seed_tail(s)
                multi = s.next_part is not None
                oi = -1
                if multi:
                    oi = len(objs)
                    objs.append(s)
                c_rows.append((ri_read[h], strand, s.target_id,
                               s.target_start, s.query_start,
                               s.total_length, tail.target_id,
                               tail.target_start, tail.query_start,
                               tail.length, oi))
                c_key.append((h << PARTBITS) | pi)

        names = ("read", "strand", "tid", "ts", "qs", "total",
                 "tail_tid", "tail_ts", "tail_qs", "tail_len", "obj")
        if c_rows:
            carr = np.array(c_rows, np.int64).T
            cols = {nm: np.concatenate([np.asarray(f[nm], np.int64),
                                        carr[i]])
                    for i, nm in enumerate(names)}
            key = np.concatenate([s_key, np.array(c_key, np.int64)])
        else:
            cols = {nm: np.asarray(f[nm], np.int64) for nm in names}
            key = s_key
        # per-read loop order: stable sort by descending total length
        # with hit/part emission order as the tiebreak (the host engine's
        # stable sort over insertion order)
        order = np.lexsort((key, -cols["total"], cols["read"]))
        cols = {nm: cols[nm][order] for nm in names}
        sa = _SeedArrays(read=cols["read"],
                         strand=cols["strand"].astype(bool),
                         tid=cols["tid"], ts=cols["ts"], qs=cols["qs"],
                         total=cols["total"], tail_tid=cols["tail_tid"],
                         tail_ts=cols["tail_ts"], tail_qs=cols["tail_qs"],
                         tail_len=cols["tail_len"], obj=cols["obj"],
                         objs=objs)
        return sa, SEQ, Ls

    # ---- wave machinery ----

    def align_batch_async(self, reads: list[FastqBig]) -> _BatchState:
        sa, seq2, Ls = self._find_seeds_arrays(reads)
        R = len(reads)
        ms = self.host._match_score[seq2.astype(np.int64)]
        css = np.zeros((2 * R, seq2.shape[1] + 1), np.int64)
        np.cumsum(ms, axis=1, out=css[:, 1:])
        # read-row cumsums only up to each read's true length (padding
        # scores 0, so full-row sums are exact)
        perfect = css[0::2, -1] if R else np.zeros(0, np.int64)
        read_of = sa.read
        full = (sa.total == Ls[read_of]) if len(read_of) else \
            np.zeros(0, bool)
        # per-read seed ranges are contiguous after the lexsort
        starts = np.searchsorted(sa.read, np.arange(R + 1))
        st = _BatchState(
            reads=reads, sa=sa, perfect=perfect.tolist(),
            extension=(perfect // 600 + Ls).tolist(),
            read_len=Ls.tolist(), seq2=seq2, css=css.tolist(),
            fullsum=css[:, -1].tolist(),
            starts=starts.tolist(), total_l=sa.total.tolist(),
            full_l=full.tolist(), strand_l=sa.strand.tolist(),
            tid_l=sa.tid.tolist(), ts_l=sa.ts.tolist(),
            qs_l=sa.qs.tolist(),
            span_l=(sa.tail_qs + sa.tail_len - sa.qs).tolist(),
            tail_end_l=(sa.tail_ts + sa.tail_len).tolist(),
            obj_l=sa.obj.tolist(),
            best_score=[0] * R, q_end=[0] * R,
            pos=[int(starts[r]) for r in range(R)],
            done=[False] * R,
            active=[r for r in range(R) if starts[r] < starts[r + 1]],
            wave=self.wave, win=[None] * R)
        self._dispatch_wave(st)
        return st

    def _dispatch_wave(self, st: _BatchState) -> None:
        """Select the next `wave` DP-NEEDING seeds per active read
        (full-length seeds are replayed inline without device work) and
        dispatch one fused device call for all of them."""
        if not st.active:
            st.pending = None
            return
        sa = st.sa
        full_l = st.full_l
        sel: list[int] = []
        for r in st.active:
            end = st.starts[r + 1]
            cnt = 0
            for gid in range(st.pos[r], end):
                if not full_l[gid]:
                    sel.append(gid)
                    cnt += 1
                    if cnt >= st.wave:
                        break
        pend: dict = {"cobj": {}, "cspan": {}, "crouted": None}
        if not sel:
            pend["sel_pos"] = {}
            pend["wh"] = []
            st.pending = pend
            return
        sel_arr = np.asarray(sel, np.int64)
        rd = sa.read[sel_arr]
        ext_need = np.asarray(st.extension, np.int64)[rd] - sa.total[sel_arr]
        left_simple = ((sa.ts[sel_arr] >= ext_need)
                       | (self._prev_cnt[sa.tid[sel_arr]] == 0))
        start_all = sa.tail_ts[sel_arr] + sa.tail_len[sel_arr]
        avail_r = (self.host._seed_table["len"][sa.tail_tid[sel_arr]]
                   - start_all)
        right_simple = ((avail_r >= ext_need)
                        | (self._next_cnt[sa.tail_tid[sel_arr]] == 0))
        simple = left_simple & right_simple

        # -- simple group: vectorized window gather --
        si = np.nonzero(simple)[0]
        g = sel_arr[si]
        rdg = rd[si]
        need = ext_need[si]
        noff = self.host._seed_table["off"]
        concat = self.host._seed_table["concat"]
        take_l = np.minimum(sa.ts[g], need)
        be_len_l = sa.qs[g]
        start = start_all[si]
        take_r = np.minimum(avail_r[si], need)
        be_off_r = sa.tail_qs[g] + sa.tail_len[g]
        be_len_r = np.asarray(st.read_len, np.int64)[rdg] - be_off_r
        rowsq = 2 * rdg + np.where(sa.strand[g], 0, 1)

        # -- complex group: reference recording recursion --
        ci = np.nonzero(~simple)[0]
        rec = _Recorder()
        for i in ci.tolist():
            gid = int(sel_arr[i])
            s = self._seed_obj(sa, gid)
            r = int(sa.read[gid])
            l0, r0 = len(rec.left_jobs), len(rec.right_jobs)
            self._record_seed(st.reads[r], s, int(st.extension[r]), rec)
            pend["cobj"][gid] = s
            pend["cspan"][gid] = (len(g) + l0, len(g) + len(rec.left_jobs),
                                  len(g) + r0, len(g) + len(rec.right_jobs))

        max_nl = int(take_l.max(initial=0))
        max_ml = int(be_len_l.max(initial=0))
        max_nr = int(take_r.max(initial=0))
        max_mr = int(be_len_r.max(initial=0))
        for a, b in rec.left_jobs:
            max_nl = max(max_nl, len(a))
            max_ml = max(max_ml, len(b))
        for a, b in rec.right_jobs:
            max_nr = max(max_nr, len(a))
            max_mr = max(max_mr, len(b))
        nl, ml = self.dp.dims_for("left", max(1, max_nl), max(1, max_ml))
        nr, mr = self.dp.dims_for("right", max(1, max_nr), max(1, max_mr))

        def gather_genome(g0, length, n):
            idx = g0[:, None] + np.arange(n)[None, :]
            out = concat[np.clip(idx, 0, len(concat) - 1)]
            return np.where(np.arange(n)[None, :] < length[:, None],
                            out, 4).astype(np.int8)

        def gather_read(off, length, n):
            idx = off[:, None] + np.arange(n)[None, :]
            out = st.seq2[rowsq[:, None],
                          np.clip(idx, 0, st.seq2.shape[1] - 1)]
            return np.where(np.arange(n)[None, :] < length[:, None],
                            out, 4).astype(np.int8)

        def stack_jobs(base_a, base_b, base_nv, base_mv, jobs, n, m):
            if not jobs:
                return (base_a, base_b, np.asarray(base_nv, np.int32),
                        np.asarray(base_mv, np.int32))
            ja = np.full((len(jobs), n), 4, np.int8)
            jb = np.full((len(jobs), m), 4, np.int8)
            jn = np.zeros(len(jobs), np.int32)
            jm = np.zeros(len(jobs), np.int32)
            for i, (a, b) in enumerate(jobs):
                ja[i, :len(a)] = a
                jb[i, :len(b)] = b
                jn[i] = len(a)
                jm[i] = len(b)
            return (np.vstack([base_a, ja]), np.vstack([base_b, jb]),
                    np.concatenate([np.asarray(base_nv, np.int32), jn]),
                    np.concatenate([np.asarray(base_mv, np.int32), jm]))

        al_l = gather_genome(noff[sa.tid[g]] + sa.ts[g] - take_l, take_l, nl)
        be_l = gather_read(np.zeros(len(g), np.int64), be_len_l, ml)
        al_r = gather_genome(noff[sa.tail_tid[g]] + start, take_r, nr)
        be_r = gather_read(be_off_r, be_len_r, mr)
        al_l, be_l, nv_l, mv_l = stack_jobs(al_l, be_l, take_l, be_len_l,
                                            rec.left_jobs, nl, ml)
        al_r, be_r, nv_r, mv_r = stack_jobs(al_r, be_r, take_r, be_len_r,
                                            rec.right_jobs, nr, mr)
        pend["wh"] = self.dp.start_wave(al_l, be_l, nv_l, mv_l,
                                        al_r, be_r, nv_r, mv_r)
        pend["sel_pos"] = {int(gid): i for i, gid in enumerate(g)}
        pend["take_l"] = take_l
        pend["start_r"] = start
        st.pending = pend

    @staticmethod
    def _seed_obj(sa: _SeedArrays, gid: int) -> Seed:
        if sa.obj[gid] >= 0:
            return sa.objs[int(sa.obj[gid])]
        return Seed(int(sa.tid[gid]), int(sa.ts[gid]), int(sa.qs[gid]),
                    int(sa.total[gid]), bool(sa.strand[gid]),
                    int(sa.total[gid]))

    def _record_seed(self, read: FastqBig, s: Seed, extension: int,
                     rec: _Recorder) -> None:
        """Run the traversal recursion for one seed with the recording
        provider (exploration is score-independent)."""
        al = self.host
        if s.total_length != len(read.seq):
            tail = al.seed_tail(s)
            seq = read.seq if s.pos_strand else read.seq_rc
            al._provider = rec
            try:
                al._left_traversal(al.g.nodes[s.target_id], s.target_start,
                                   extension - s.total_length,
                                   seq[:s.query_start])
                al._right_traversal(al.g.nodes[tail.target_id],
                                    tail.target_start + tail.length,
                                    extension - s.total_length,
                                    seq[tail.query_start + tail.length:])
            finally:
                al._provider = None

    def _collect_wave(self, st: _BatchState) -> None:
        """Fetch this wave's DP results and advance every active read's
        seed loop as far as possible: full-length seeds replay inline
        (no device data), other seeds consume this wave's results, and
        the reference's seedCouldBeBetter bound (toGiraf.go:38) is
        checked eagerly so a read stops the moment it is decided."""
        sa = st.sa
        pend = st.pending
        lmeta, lops, rmeta, rops = self.dp.finish_wave(pend["wh"])
        al = self.host
        sel_pos = pend["sel_pos"]
        cspan = pend["cspan"]
        take_l = pend.get("take_l")
        start_r = pend.get("start_r")
        total_l, full_l = st.total_l, st.full_l
        strand_l, qs_l, span_l = st.strand_l, st.qs_l, st.span_l
        ts_l, tail_end_l, tid_l, obj_l = (st.ts_l, st.tail_end_l,
                                          st.tid_l, st.obj_l)
        css, fullsum = st.css, st.fullsum

        def croutes(j0, j1, meta, ops):
            return [(int(meta[j][0]), self._route_of(ops, j),
                     int(meta[j][1]), int(meta[j][2]))
                    for j in range(j0, j1)]

        still: list[int] = []
        for r in st.active:
            end = st.starts[r + 1]
            read = st.reads[r]
            rl = st.read_len[r]
            perfect = st.perfect[r]
            best = st.best_score[r]
            gid = st.pos[r]
            while gid < end:
                total = total_l[gid]
                if not seed_could_be_better(total, best, perfect, rl,
                                            100, 90, -196, -296):
                    st.done[r] = True
                    break
                strand = strand_l[gid]
                qs = qs_l[gid]
                rowq = 2 * r + (0 if strand else 1)
                if full_l[gid]:
                    curr = fullsum[rowq]
                    if curr > best:
                        best = curr
                        oi = obj_l[gid]
                        path = (al._seed_path(sa.objs[oi]) if oi >= 0
                                else [tid_l[gid]])
                        st.win[r] = _Win(
                            curr=curr, t_start=ts_l[gid],
                            t_end=tail_end_l[gid], q_start=qs,
                            q_end_carry=st.q_end[r], strand=strand,
                            seed_qs=qs, seed_total=total, path=path,
                            routes=("full",))
                    gid += 1
                    continue
                i = sel_pos.get(gid)
                if i is not None:       # simple seed, this wave's rows
                    cs = css[rowq]
                    seed_score = cs[qs + span_l[gid]] - cs[qs]
                    lm = lmeta[i]
                    rm = rmeta[i]
                    ls, li, lj = int(lm[0]), int(lm[1]), int(lm[2])
                    rs_, ri_, rj = int(rm[0]), int(rm[1]), int(rm[2])
                    t_start = ts_l[gid] - int(take_l[i]) + li
                    q_start = lj
                    t_end = ri_ + int(start_r[i])
                    st.q_end[r] = rj
                    curr = ls + seed_score + rs_
                    if curr > best:
                        best = curr
                        oi = obj_l[gid]
                        path = (al._seed_path(sa.objs[oi]) if oi >= 0
                                else [tid_l[gid]])
                        st.win[r] = _Win(
                            curr=curr, t_start=t_start, t_end=t_end,
                            q_start=q_start, q_end_carry=rj,
                            strand=strand, seed_qs=qs, seed_total=total,
                            path=path,
                            routes=("rows", lops, i, rops, i))
                    gid += 1
                    continue
                span4 = cspan.get(gid)
                if span4 is not None:   # complex seed: replay recursion
                    s = pend["cobj"][gid]
                    l0, l1, r0, r1 = span4
                    tail = al.seed_tail(s)
                    seq = read.seq if s.pos_strand else read.seq_rc
                    al._provider = _Replayer(croutes(l0, l1, lmeta, lops),
                                             croutes(r0, r1, rmeta, rops))
                    try:
                        lroute, lsc, t_start, q_start = al._left_traversal(
                            al.g.nodes[s.target_id], s.target_start,
                            st.extension[r] - total, seq[:s.query_start])
                        rroute, rsc, t_end, qe = al._right_traversal(
                            al.g.nodes[tail.target_id],
                            tail.target_start + tail.length,
                            st.extension[r] - total,
                            seq[tail.query_start + tail.length:])
                    finally:
                        al._provider = None
                    st.q_end[r] = qe
                    cs = css[rowq]
                    seed_score = cs[qs + span_l[gid]] - cs[qs]
                    curr = lsc + seed_score + rsc
                    if curr > best:
                        best = curr
                        oi = obj_l[gid]
                        path = (al._seed_path(sa.objs[oi]) if oi >= 0
                                else [tid_l[gid]])
                        st.win[r] = _Win(
                            curr=curr, t_start=int(t_start),
                            t_end=int(t_end), q_start=int(q_start),
                            q_end_carry=int(qe), strand=strand,
                            seed_qs=qs, seed_total=total, path=path,
                            routes=("routes", lroute, rroute))
                    gid += 1
                    continue
                break  # DP-needing seed without results: next wave
            st.best_score[r] = best
            st.pos[r] = gid
            if not st.done[r] and gid < end:
                still.append(r)
        st.active = still

    @staticmethod
    def _concat3(left_route, total: int, right_route) -> list[CigarOp]:
        """left + [M total] + right with adjacent runs merged, in one
        pass."""
        out = [CigarOp(c.run_length, c.op) for c in left_route]
        if out and out[-1].op == "M":
            out[-1].run_length += total
        else:
            out.append(CigarOp(total, "M"))
        for c in right_route:
            if out[-1].op == c.op:
                out[-1].run_length += c.run_length
            else:
                out.append(CigarOp(c.run_length, c.op))
        return out

    @staticmethod
    def _route_of(ops: np.ndarray, row: int) -> list[CigarOp]:
        """Walk-order route of one result row (codes 0=M, 1=I, 2=D,
        >=3 stop), matching gsw_dp._routes_walk_order."""
        o = ops[row]
        stop = o >= 3
        end = int(stop.argmax()) if stop.any() else len(o)
        o = o[:end]
        if end == 0:
            return []
        chg = np.nonzero(np.diff(o))[0] + 1
        bounds = np.concatenate(([0], chg, [end]))
        chars = "MID"
        return [CigarOp(int(bounds[i + 1] - bounds[i]), chars[int(o[bounds[i]])])
                for i in range(len(bounds) - 1)]

    def finish_batch(self, st: _BatchState) -> list[Giraf]:
        while st.pending is not None and st.active:
            self._collect_wave(st)
            if not st.active:
                break
            st.wave = min(st.wave * 4, 512)
            self._dispatch_wave(st)
        if st.pending is not None and not st.active:
            st.pending = None
        self._extract_winner_routes(st)
        return [self._finalize(st, r) for r in range(len(st.reads))]

    @staticmethod
    def _extract_winner_routes(st: _BatchState) -> None:
        """Run-length code the walk rows of every 'rows' winner in one
        vectorized pass per wave array."""
        groups: dict[int, tuple] = {}
        members: dict[int, list] = {}
        for r, w in enumerate(st.win):
            if w is not None and w.routes[0] == "rows":
                _, lops, li, rops, ri = w.routes
                key = id(lops)
                groups[key] = (lops, rops)
                members.setdefault(key, []).append((r, li, ri))
        for key, (lops, rops) in groups.items():
            mem = members[key]
            lrows = np.asarray([m[1] for m in mem])
            rrows = np.asarray([m[2] for m in mem])
            lroutes = _routes_walk_order(lops[lrows])
            rroutes = _routes_walk_order(rops[rrows])
            for (r, _, _), lr, rr in zip(mem, lroutes, rroutes):
                st.win[r].routes = ("routes", lr, rr)

    def _finalize(self, st: _BatchState, r: int) -> Giraf:
        read = st.reads[r]
        best = Giraf(qname=read.name, q_start=0, q_end=0, pos_strand=True,
                     path=Path(), cigar=[], aln_score=0, mapq=255,
                     seq=read.seq, qual=read.qual,
                     notes=[Note("XO", "Z", "~")])
        w: _Win | None = st.win[r]
        if w is not None:
            spec = w.routes
            if spec[0] == "full":
                lroute: list[CigarOp] = []
                rroute: list[CigarOp] = []
            elif spec[0] == "rows":
                lroute = self._route_of(spec[1], spec[2])
                rroute = self._route_of(spec[3], spec[4])
            else:
                lroute, rroute = spec[1], spec[2]
            mid = self._concat3(lroute, w.seed_total, rroute)
            seq = read.seq if w.strand else read.seq_rc
            best.q_start = w.q_start
            best.q_end = (w.seed_qs + w.q_start + w.q_end_carry
                          + w.seed_total - 1)
            best.pos_strand = w.strand
            best.path = Path(w.t_start, w.path, w.t_end)
            best.cigar = _append_soft_clips(w.q_start, len(seq), mid)
            best.aln_score = w.curr
            best.seq = seq
        if not best.pos_strand:
            best.qual = best.qual[::-1]
        return best

    def align_batch(self, reads: list[FastqBig]) -> list[Giraf]:
        st = self.align_batch_async(reads)
        return self.finish_batch(st)

    def align_pair_batch(self, pairs):
        """Both reads of each pair aligned in one batch, with the pair
        flags of the host engine's ``align_pair``."""
        flat: list[FastqBig] = []
        for a, b in pairs:
            flat.append(a)
            flat.append(b)
        girafs = self.align_batch(flat)
        out = []
        for i in range(0, len(girafs), 2):
            a, b = girafs[i], girafs[i + 1]
            a.flag = self.host._giraf_flags(a) + 8 + 16 + 16
            b.flag = self.host._giraf_flags(b)
            if self.host._is_proper_pair(a, b):
                a.flag += 1
                b.flag += 1
            out.append((a, b))
        return out
