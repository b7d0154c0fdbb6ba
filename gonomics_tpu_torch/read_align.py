"""Batched read aligner: seed -> vote on the host, banded local DP and
packed traceback on the card, SAM on the host.

The counterpart of ``TpuReadAligner`` (``gonomics_tpu/tpu_align.py``):

  host (numpy and the native runtime, vectorized over the batch):
    - a sorted (code, pos) k-mer table (dense) or the step-sampled
      two-level table (sparse), probed for every read k-mer at once;
    - the modal diagonal of the seed hits anchors each read's window.
  device (``ops/banded.py`` ``banded_align_full``):
    - one launch of the fused kernel fills a 64-lane band per read,
      keeps its trace in shared memory, finds the best cell, walks the
      trace back and packs the ops (reads too long for the trace to fit
      a block's shared memory take ``banded_dp``, which writes the trace,
      then ``best_cell`` and ``banded_walk_pack``); one uint8 array per
      batch (20 bytes of meta + packed ops) comes back to pinned host
      memory.
    - with a mesh (``parallel.make_mesh``), as the JAX aligner's mesh
      path: the batch split over the mesh's "data" axis, each slice
      through ``ops.wavefront.local_align_full`` (K4 over each read's
      whole (L, L + 2 pad) grid, then the best cell, the walk and the
      packing; a trace of (2 L + 2 pad)(L + 1) bytes a read on the card)
      on its own device, the results gathered in batch order
      (``parallel.shard_local_align``).
    - with a mesh and ``index_sharding="prefix"``, the dense table split
      into one chunk a row of the mesh's "data" axis, each on its row's
      device (``split_index_prefix``, ``parallel.place_index_chunks``);
      the read k-mers are looked up there (``parallel.shard_seed_lookup``)
      and the votes counted on the host in numpy.
  host:
    - cigars, soft clips and SAM text; MapQ from the vote margin.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import DeviceResult, dna, native, resolve_device
from .align.matrices import HUMAN_CHIMP_TWO
from .io import sam as samio
from .io.chrom_info import ChromInfo
from .io.cigar import CigarOp
from .io.fasta import Fasta
from .io.fastq import Fastq, qual_string
from .ops.banded import banded_align_full, unpack_ops, walk_length
from .parallel import (code_keys, normal_device, place_index_chunks,
                       shard_local_align, shard_seed_lookup)


def _window_codes_fast(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint64, valid bool) of every k-window: power-of-2 window
    codes are built by combining half-width codes, then k is composed
    from its binary decomposition; validity (no base >= 4 in the window)
    comes from one cumsum."""
    n = len(s) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    vals = np.where(s < 4, s, 0).astype(np.uint8)
    pw = {1: vals}
    w = 1
    while w * 2 <= k:
        a = pw[w]
        nb = 4 * w  # bits of the doubled code
        dt = (np.uint8 if nb <= 8 else np.uint16 if nb <= 16
              else np.uint32 if nb <= 32 else np.uint64)
        pw[w * 2] = (a[:len(a) - w].astype(dt) << (2 * w)) | a[w:]
        w *= 2
    rem, off, code = k, 0, None
    for w in sorted(pw, reverse=True):
        if rem >= w:
            part = pw[w][off:off + n]
            if code is None:
                code = part.astype(np.uint64)
            else:
                code = (code << np.uint64(2 * w)) | part
            off += w
            rem -= w
    bad = (s >= 4).astype(np.int32)
    cs = np.concatenate([np.zeros(1, np.int32), np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return code, valid


def build_seed_index(genome: np.ndarray, k: int,
                     chunk: int = 1 << 24) -> tuple[np.ndarray, np.ndarray]:
    """Sorted (code, pos) table of every valid k-mer window, built in
    chunks so temporaries stay O(chunk); the stable sort runs through
    torch's multithreaded argsort on the host."""
    n = len(genome)
    pos_dtype = np.int32 if n < 2 ** 31 else np.int64
    codes_parts = []
    pos_parts = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk + k - 1)  # k-1 overlap covers the seam
        c, valid = _window_codes_fast(genome[lo:hi], k)
        c, valid = c[:chunk], valid[:chunk]
        p = np.nonzero(valid)[0].astype(pos_dtype)
        p += pos_dtype(lo)
        codes_parts.append(c[valid])
        pos_parts.append(p)
    codes = np.concatenate(codes_parts) if codes_parts else \
        np.zeros(0, np.uint64)
    pos = np.concatenate(pos_parts) if pos_parts else \
        np.zeros(0, pos_dtype)
    # codes < 2^63 (invalid windows were dropped), so int64 order matches
    ct = torch.from_numpy(codes.view(np.int64))
    order = torch.argsort(ct, stable=True)
    return (ct[order].numpy().view(np.uint64),
            torch.from_numpy(pos)[order].numpy())


_PAD_CODE = np.uint64(1) << np.uint64(63)  # > any real or bad-window code


def split_index_prefix(codes: np.ndarray, pos: np.ndarray,
                       n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """The sorted (code, pos) table split into n_shards contiguous chunks
    whose boundaries fall between distinct codes, so that every k-mer's
    run lies in one chunk; the chunks padded with ``_PAD_CODE`` (position
    0) to the longest one's length L >= 1. Returns (codes (n, L) uint64,
    pos (n, L)), as ``gonomics_tpu/tpu_align.py:136-159`` does; the
    positions are int32 where every one fits, else int64 (the JAX casts
    them to int32, which wraps past 2^31 bases)."""
    N = len(codes)
    bounds = [0]
    for i in range(1, n_shards):
        t = i * N // n_shards
        if 0 < t < N:
            # move back to the first occurrence of codes[t]: a boundary
            t = int(np.searchsorted(codes, codes[t], side="left"))
        bounds.append(max(bounds[-1], min(t, N)))
    bounds.append(N)
    L = max(1, max(bounds[i + 1] - bounds[i] for i in range(n_shards)))
    fits = N == 0 or int(pos.max()) < 2 ** 31
    ck = np.full((n_shards, L), _PAD_CODE, np.uint64)
    ps = np.zeros((n_shards, L), np.int32 if fits else np.int64)
    for i in range(n_shards):
        lo, hi = bounds[i], bounds[i + 1]
        ck[i, :hi - lo] = codes[lo:hi]
        ps[i, :hi - lo] = pos[lo:hi]
    return ck, ps


def _batch_codes(seqs: np.ndarray, offsets: np.ndarray, k: int) -> np.ndarray:
    """(B, K) codes of the k-mers starting at the given offsets."""
    B = seqs.shape[0]
    vals = np.where(seqs < 4, seqs, 0).astype(np.uint64)
    codes = np.zeros((B, len(offsets)), np.uint64)
    for j in range(k):
        codes = (codes << np.uint64(2)) | vals[:, offsets + j]
    bad = np.zeros((B, seqs.shape[1] + 1), np.int32)
    np.cumsum(seqs >= 4, axis=1, out=bad[:, 1:])
    badwin = (bad[:, offsets + k] - bad[:, offsets]) > 0
    codes[badwin] = np.uint64(1) << np.uint64(62)  # never matches genome
    return codes


@dataclass
class _Candidate:
    diag: np.ndarray       # (B,) best diagonal (genome pos of read start)
    votes: np.ndarray      # (B,) votes for the best diagonal
    second: np.ndarray     # (B,) votes for the runner-up diagonal
    strand: np.ndarray     # (B,) True = forward


class ReadAligner:
    def __init__(self, records, *, seed_len: int = 21, read_kmers: int = 8,
                 max_hits_per_kmer: int = 8, pad: int = 24,
                 scores: np.ndarray = HUMAN_CHIMP_TWO, gap: int = -600,
                 min_score: int = 1200, device=None, mesh=None,
                 index_sharding: str = "replicated", _index=None,
                 index_mode: str = "dense", index_step: int = 8):
        """records: list of io.fasta.Fasta (the linear reference).

        device: where the banded DP runs; None means the card, and the
        CPU (the kernels' plain versions) only when "cpu" is passed.
        mesh: a ``parallel.Mesh``; when given, the device step runs
        data-parallel over its "data" axis (``shard_local_align``), and
        the aligner's device is the mesh's first (a ``device`` that
        differs raises ValueError). Outputs stay in batch order, so the
        SAM is the same for any mesh.
        index_sharding: "replicated" (the whole table on the host) or
        "prefix" (one chunk of the dense table a row of the mesh's
        "data" axis, looked up on its device; needs a mesh and the dense
        index). The SAM is the same for both.
        _index: a prebuilt (codes, pos) table from from_state()/load()."""
        if mesh is not None:
            first = mesh.devices[0][0]
            if device is not None and normal_device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        if index_sharding not in ("replicated", "prefix"):
            raise ValueError(f"unknown index_sharding: {index_sharding}")
        if index_sharding == "prefix" and mesh is None:
            raise ValueError("index_sharding='prefix' needs a mesh")
        if index_mode not in ("dense", "sparse"):
            raise ValueError(f"unknown index_mode: {index_mode}")
        if index_sharding == "prefix" and index_mode != "dense":
            raise ValueError("index_sharding='prefix' needs "
                             "index_mode='dense'")
        self.device = resolve_device(device)
        self.mesh = mesh
        self._sharded_fns: dict = {}  # (L, W) -> shard_local_align's
        self.k = seed_len
        self.read_kmers = read_kmers
        self.max_hits = max_hits_per_kmer
        self.pad = pad
        self.scores = np.asarray(scores, np.int64)
        self.gap = gap
        self.min_score = min_score
        self._scores_dev = torch.as_tensor(self.scores, dtype=torch.int32,
                                           device=self.device)

        # concatenate chromosomes with N spacers so windows never span two
        sep = 512
        chunks = []
        self.chrom_starts = []
        self.chroms: list[ChromInfo] = []
        off = 0
        for i, rec in enumerate(records):
            seq = dna.to_upper(rec.seq).astype(np.int8, copy=False)
            self.chrom_starts.append(off)
            self.chroms.append(ChromInfo(rec.name, len(seq), i))
            chunks.append(seq)
            chunks.append(np.full(sep, dna.N, np.int8))
            off += len(seq) + sep
        self.genome = np.concatenate(chunks)
        self._starts_arr = np.array(self.chrom_starts + [off], np.int64)

        self.index_mode = index_mode
        self.index_step = index_step
        self._sparse = None
        if index_mode == "sparse":
            # step-sampled positions only; reads probe every offset, so
            # any sampled genome occurrence is found
            self.idx_codes = self.idx_pos = None
            n_pos = max(2, (len(self.genome) - self.k) // index_step + 1)
            # bucket bits: at most 22 (table + build histograms dominate
            # memory beyond) and at most 2k (the C bucket shift must be
            # >= 0)
            self._sparse_bb = min(22, max(12, int(np.log2(n_pos)) - 3),
                                  2 * self.k)
            got = native.sparse_index_build(self.genome, self.k,
                                            index_step, self._sparse_bb)
            if got is not None:
                self._sparse = got
            else:
                self._sparse_fallback = self._build_sparse_fallback()
        elif _index is not None:
            self.idx_codes, self.idx_pos = _index
        else:
            self.idx_codes, self.idx_pos = build_seed_index(self.genome,
                                                            self.k)
        self.index_sharding = index_sharding
        self._shard_lookup = self._shards = None
        if index_sharding == "prefix":
            self._shards = place_index_chunks(mesh, *split_index_prefix(
                self.idx_codes, self.idx_pos, mesh.shape["data"]))
            self._shard_lookup = shard_seed_lookup(mesh,
                                                   max_hits=self.max_hits)

    # ---- index persistence ----

    def state(self) -> dict[str, np.ndarray]:
        """The aligner's index and layout as numpy arrays: the keys of
        ``TpuReadAligner.save_index``'s file plus the score matrix and
        gap."""
        if self.index_mode != "dense":
            raise ValueError("only the dense index is saved")
        return {"k": np.int64(self.k), "codes": self.idx_codes,
                "pos": self.idx_pos, "genome": self.genome,
                "starts": self._starts_arr,
                "names": np.array([c.name for c in self.chroms]),
                "sizes": np.array([c.size for c in self.chroms], np.int64),
                "scores": self.scores, "gap": np.int64(self.gap)}

    def save_index(self, path: str) -> None:
        """Write ``state()`` to an ``.npz`` file that both packages load."""
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 **self.state())

    @classmethod
    def from_state(cls, state: dict[str, np.ndarray], **kwargs):
        """Rebuild an aligner from ``state()`` arrays (or those of the JAX
        aligner's index file): no FASTA scan, no sort. ``scores`` and
        ``gap`` come from the state when it has them, unless given."""
        kwargs.setdefault("seed_len", int(state["k"]))
        if kwargs["seed_len"] != int(state["k"]):
            raise ValueError(f"index built with k={int(state['k'])}, "
                             f"asked k={kwargs['seed_len']}")
        if "scores" in state:
            kwargs.setdefault("scores", np.asarray(state["scores"]))
        if "gap" in state:
            kwargs.setdefault("gap", int(state["gap"]))
        names = [str(x) for x in state["names"]]
        sizes = [int(x) for x in state["sizes"]]
        starts = state["starts"]
        genome = state["genome"]
        records = [Fasta(nm, genome[int(starts[i]):int(starts[i]) + sizes[i]])
                   for i, nm in enumerate(names)]
        return cls(records, _index=(state["codes"], state["pos"]), **kwargs)

    @classmethod
    def load(cls, path: str, **kwargs):
        """Rebuild an aligner from an index file written by either
        package's ``save_index``."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            state = {key: z[key] for key in z.files}
        return cls.from_state(state, **kwargs)

    def header(self) -> samio.Header:
        h = samio.Header()
        h.text = ["@HD\tVN:1.6\tSO:unsorted"] + [
            f"@SQ\tSN:{c.name}\tLN:{c.size}" for c in self.chroms]
        h.chroms = list(self.chroms)
        h.sort_order = ["unsorted"]
        return h

    # ---- seeding ----

    def _lookup_hits(self, codes: np.ndarray):
        """(B, K) k-mer codes -> (hitpos (B, K, H), valid): from the
        prefix-sharded chunks on the mesh's devices, or from the dense
        host table in numpy (where the native library is there, the
        replicated table's lookup and vote are one pass of
        ``native.seed_vote``)."""
        B, K = codes.shape
        H = self.max_hits
        if self._shard_lookup is not None:
            hp, valid = self._shard_lookup(*self._shards, code_keys(codes))
            return hp.cpu().numpy().astype(np.int64), valid.cpu().numpy()
        # probe in sorted-query order for locality
        q = codes.ravel()
        order = np.argsort(q, kind="stable")
        qs = q[order]
        lo = np.empty(q.shape, np.int64)
        hi = np.empty(q.shape, np.int64)
        lo[order] = np.searchsorted(self.idx_codes, qs, side="left")
        hi[order] = np.searchsorted(self.idx_codes, qs, side="right")
        lo = lo.reshape(B, K)
        hi = hi.reshape(B, K)
        hi = np.minimum(hi, lo + H)
        take = lo[:, :, None] + np.arange(H)[None, None, :]  # (B, K, H)
        valid = take < hi[:, :, None]
        take = np.clip(take, 0, len(self.idx_pos) - 1)
        return self.idx_pos[take].astype(np.int64), valid

    def _vote(self, hitpos: np.ndarray, valid: np.ndarray,
              offs: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        B, K, H = hitpos.shape
        diags = hitpos - offs[None, :, None]
        diags = np.where(valid, diags, np.int64(-1))
        # modal diagonal per read: sort the small (K*H) candidate list
        flat = np.sort(diags.reshape(B, K * H), axis=1)
        KH = flat.shape[1]
        jj = np.arange(KH, dtype=np.int64)

        def runlen(same_prev: np.ndarray) -> np.ndarray:
            """run[:, j] = length of the streak ending at j, where
            same_prev[:, j-1] says element j continues the streak."""
            chg = np.ones((B, KH), bool)
            chg[:, 1:] = ~same_prev
            last = np.maximum.accumulate(
                np.where(chg, jj[None, :], 0), axis=1)
            return jj[None, :] - last

        run = runlen(flat[:, 1:] == flat[:, :-1])
        run[flat == -1] = -1
        bestj = np.argmax(run, axis=1)
        votes = run[np.arange(B), bestj] + 1
        diag = flat[np.arange(B), bestj]
        votes = np.where(diag == -1, 0, votes)
        # runner-up votes on a different diagonal (for MapQ)
        masked = np.where(flat == diag[:, None], -1, flat)
        run2 = runlen((masked[:, 1:] == masked[:, :-1])
                      & (masked[:, 1:] != -1))
        second = run2.max(axis=1) + 1
        second = np.where((masked != -1).any(axis=1), second, 0)
        return diag, votes, second

    def _build_sparse_fallback(self):
        """numpy stand-in for the native sparse index: sorted codes of the
        step-sampled positions."""
        sampled = np.arange(0, len(self.genome) - self.k + 1,
                            self.index_step)
        codes, valid = _window_codes_fast(self.genome, self.k)
        codes = codes[sampled]
        valid = valid[sampled]
        pos = sampled[valid].astype(np.int64)
        codes = codes[valid]
        order = np.argsort(codes, kind="stable")
        return codes[order], pos[order]

    @staticmethod
    def _pick_strand(fwd_vote, rev_vote) -> _Candidate:
        df, vf, sf = fwd_vote
        dr, vr, sr = rev_vote
        use_fwd = vf >= vr
        return _Candidate(
            diag=np.where(use_fwd, df, dr),
            votes=np.where(use_fwd, vf, vr),
            second=np.where(use_fwd, np.maximum(sf, vr), np.maximum(sr, vf)),
            strand=use_fwd)

    def _candidates_sparse(self, fwd: np.ndarray,
                           rev: np.ndarray) -> _Candidate:
        if self._sparse is not None:
            pos, rem, boff = self._sparse
            got = native.sparse_seed_vote(fwd, rev, self.k, self.genome,
                                          pos, rem, boff,
                                          self._sparse_bb, self.max_hits)
            if got is not None:
                diag, votes, second, strand = got
                return _Candidate(diag=diag, votes=votes, second=second,
                                  strand=strand)
        # numpy fallback: probe every offset against the sampled table
        B, L = fwd.shape
        codes_t, pos_t = self._sparse_fallback
        offs = np.arange(0, L - self.k + 1, dtype=np.int64)
        codes = np.concatenate([_batch_codes(fwd, offs, self.k),
                                _batch_codes(rev, offs, self.k)])
        q = codes.ravel()
        lo = np.searchsorted(codes_t, q, side="left").reshape(codes.shape)
        hi = np.searchsorted(codes_t, q, side="right").reshape(codes.shape)
        hi = np.minimum(hi, lo + self.max_hits)
        H = self.max_hits
        take = lo[:, :, None] + np.arange(H)[None, None, :]
        valid = take < hi[:, :, None]
        take = np.clip(take, 0, max(0, len(pos_t) - 1))
        hitpos = (pos_t[take] if len(pos_t) else
                  np.zeros(take.shape, np.int64)).astype(np.int64)
        return self._pick_strand(self._vote(hitpos[:B], valid[:B], offs),
                                 self._vote(hitpos[B:], valid[B:], offs))

    def _candidates(self, fwd: np.ndarray, rev: np.ndarray) -> _Candidate:
        if self.index_mode == "sparse":
            return self._candidates_sparse(fwd, rev)
        B, L = fwd.shape
        offs = np.linspace(0, L - self.k, self.read_kmers).astype(np.int64)
        if self._shard_lookup is None:
            got = native.seed_vote(fwd, rev, offs, self.k, self.idx_codes,
                                   self.idx_pos, self.max_hits)
            if got is not None:  # whole seed+vote stage, one C pass
                diag, votes, second, strand = got
                return _Candidate(diag=diag, votes=votes, second=second,
                                  strand=strand)
        # the prefix-sharded lookup, or the numpy fallback: one index
        # lookup for both strands
        codes = np.concatenate([_batch_codes(fwd, offs, self.k),
                                _batch_codes(rev, offs, self.k)])
        hitpos, valid = self._lookup_hits(codes)
        return self._pick_strand(self._vote(hitpos[:B], valid[:B], offs),
                                 self._vote(hitpos[B:], valid[B:], offs))

    # ---- alignment ----

    def align_batch(self, reads: list[Fastq]) -> list[samio.Sam]:
        return self.finish_batch(self.align_batch_async(reads))

    def align_batch_async(self, reads: list[Fastq]):
        """Host seeding, then the device step launched without waiting;
        pair with finish_batch or finish_batch_lines. The result's copy
        to pinned host memory is queued behind the kernels, so the caller
        can seed the next batch while this one runs on the card."""
        B = len(reads)
        lens = np.fromiter((len(r.seq) for r in reads), np.int64, B)
        L = int(lens.max())
        fwd = np.full((B, L), dna.N, np.int8)
        if bool((lens == L).all()):
            for i, r in enumerate(reads):
                fwd[i] = r.seq
            rev = dna.complement(fwd[:, ::-1]).astype(np.int8)
        else:
            for i, r in enumerate(reads):
                fwd[i, :len(r.seq)] = r.seq
            rev = np.full((B, L), dna.N, np.int8)
            for i, r in enumerate(reads):
                rc = dna.reverse_complement(r.seq).astype(np.int8)
                rev[i, :len(rc)] = rc

        cand = self._candidates(fwd, rev)
        W = L + 2 * self.pad
        starts = np.clip(cand.diag - self.pad, 0, len(self.genome) - W)
        read_seqs = np.where(cand.strand[:, None], fwd, rev)
        windows = self.genome[starts[:, None] + np.arange(W)]
        res = self._device_result(read_seqs, windows, lens.astype(np.int32),
                                  np.full(B, W, np.int32))
        # the mesh path walks the whole (L, W) grid
        walk_d = walk_length(L) if self.mesh is None else L + W
        return reads, cand, starts, lens, read_seqs, res, walk_d

    def _align_full(self, L: int, W: int):
        """The device step for reads of L in windows of W: the banded
        ``banded_align_full``, or with a mesh its ``shard_local_align``
        (made once a shape, as the JAX aligner caches it)."""
        if self.mesh is None:
            return lambda *args: banded_align_full(*args, self._scores_dev,
                                                   self.gap)
        fn = self._sharded_fns.get((L, W))
        if fn is None:
            fn = shard_local_align(self.mesh, self.scores, n=L, m=W,
                                   gap=self.gap)
            self._sharded_fns[(L, W)] = fn
        return fn

    def _device_result(self, read_seqs, windows, n_vec, m_vec) -> DeviceResult:
        """Upload one batch, run the device step (``_align_full``) and
        pack score, i_end, j_end, i0, j0 (little-endian int32) and the
        packed ops into one (B, 20 + P) uint8 array, as ``_banded_driver``
        (tpu_align.py:595-631) does."""
        dev = self.device
        on_card = dev.type == "cuda"

        def up(x: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory().to(dev, non_blocking=True) if on_card else t

        align = self._align_full(read_seqs.shape[1], windows.shape[1])
        score, i_end, j_end, i0, j0, packed = align(
            up(read_seqs), up(windows), up(n_vec), up(m_vec))
        meta8 = torch.stack([score, i_end, j_end, i0, j0], dim=1).view(
            torch.uint8)  # (B, 5) int32 -> (B, 20) little-endian bytes
        return DeviceResult(torch.cat([meta8, packed], dim=1))

    @staticmethod
    def _decode_res(res: DeviceResult):
        """(score, i_end, j_end, i0, j0, packed-ops), waiting for the copy."""
        buf = res.numpy()
        meta = np.ascontiguousarray(buf[:, :20]).view(np.int32)
        return (meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3],
                meta[:, 4], buf[:, 20:])

    def finish_batch(self, handle) -> list[samio.Sam]:
        """Wait for the device result of align_batch_async and emit SAM."""
        reads, cand, starts, lens, _seqs, res, walk_d = handle
        score, i_end, _j_end, i0, j0, packed = self._decode_res(res)
        ops = unpack_ops(np.asarray(packed[:len(reads)]), walk_d)
        routes = self._routes_from_ops_batch(ops)
        return [self._emit(r, b, score, i_end, i0, j0, routes[b], cand,
                           starts, int(lens[b]))
                for b, r in enumerate(reads)]

    def finish_batch_lines(self, handle) -> str:
        """finish_batch, emitting the whole batch as SAM text through the
        native bulk formatter: byte-identical to joining finish_batch()'s
        to_string()s. Takes the object path for non-uniform read lengths
        or a missing native library."""
        reads, cand, starts, lens, read_seqs, res, walk_d = handle
        B = len(reads)
        lens = np.asarray(lens)
        if not native.available() or not (lens == lens[0]).all():
            return "".join(s.to_string() + "\n"
                           for s in self.finish_batch(handle))
        score, i_end, _j, i0, j0, packed = self._decode_res(res)
        score, i_end, i0, j0 = (x[:B] for x in (score, i_end, i0, j0))

        mapped = (score >= self.min_score) & (cand.votes > 0)
        # the library is loaded (checked above) and its run buffer holds
        # every walk, so this returns the runs
        cig_off, cig_cnt, run_lens, run_ops, mapped = native.walk_to_cigars(
            packed[:B], walk_d, i0, i_end, lens, mapped)

        gpos = starts[:B] + j0
        ci = np.searchsorted(self._starts_arr, gpos, side="right") - 1
        pos = gpos - self._starts_arr[ci] + 1
        rsel = np.where(mapped, ci, -1).astype(np.int32)
        poss = np.where(mapped, pos, 0).astype(np.int32)
        flags = np.where(mapped, np.where(cand.strand, 0, 16),
                         4).astype(np.int32)
        margin = (cand.votes - cand.second).astype(np.int64)
        mapqs = np.where(mapped, np.clip(10 * margin + 10, 0, 60),
                         0).astype(np.int32)
        quals = np.stack([r.qual for r in reads]).astype(np.uint8)
        rev = ~np.asarray(cand.strand)
        quals[rev] = quals[rev, ::-1]
        text = native.format_sam_lines(
            "\n".join(r.name for r in reads),
            [c.name for c in self.chroms], flags, rsel, poss, mapqs,
            score.astype(np.int64), mapped.astype(np.uint8),
            read_seqs[:B], quals, lens.astype(np.int32),
            cig_off, cig_cnt, run_lens, run_ops)
        if text is None:
            return "".join(s.to_string() + "\n"
                           for s in self.finish_batch(handle))
        return text

    @staticmethod
    def _routes_from_ops_batch(ops: np.ndarray) -> list[list[CigarOp]]:
        """Backward-walk op codes -> forward run-length cigars for the
        whole batch in one vectorized run-length pass."""
        B, D = ops.shape
        stop = ops >= 3
        row_ends = np.where(stop.any(axis=1), stop.argmax(axis=1), D)
        col = np.arange(D)[None, :]
        valid = col < row_ends[:, None]
        change = np.ones((B, D), bool)
        change[:, 1:] = ops[:, 1:] != ops[:, :-1]
        change &= valid
        rows, starts = np.nonzero(change)  # row-major: runs in order
        if len(rows) == 0:
            return [[] for _ in range(B)]
        run_ops = ops[rows, starts]
        ends = np.empty_like(starts)
        same_row = rows[:-1] == rows[1:]
        ends[:-1] = np.where(same_row, starts[1:], row_ends[rows[:-1]])
        ends[-1] = row_ends[rows[-1]]
        lengths = (ends - starts).tolist()
        chars = "MDI"
        routes: list[list[CigarOp]] = [[] for _ in range(B)]
        for r, o, ln in zip(rows.tolist(), run_ops.tolist(), lengths):
            routes[r].append(CigarOp(ln, chars[o]))
        for route in routes:
            route.reverse()
        return routes

    def _locate(self, gpos: int) -> tuple[str, int]:
        ci = int(np.searchsorted(self._starts_arr, gpos, side="right")) - 1
        return self.chroms[ci].name, gpos - self.chrom_starts[ci]

    def _emit(self, r: Fastq, b: int, score, i_end, i0, j0, route,
              cand: _Candidate, starts, read_len: int) -> samio.Sam:
        strand = bool(cand.strand[b])
        qual = r.qual if strand else r.qual[::-1]
        seq = r.seq if strand else dna.reverse_complement(r.seq).astype(np.int8)
        s = samio.Sam(qname=r.name, flag=4, rname="*", pos=0, mapq=0,
                      cigar=[CigarOp(0, "*")], rnext="*", pnext=0, tlen=0,
                      seq=seq, qual=qual_string(qual))
        if score[b] < self.min_score or cand.votes[b] == 0 or not route:
            return s
        cig: list[CigarOp] = []
        if i0[b] > 0:
            cig.append(CigarOp(int(i0[b]), "S"))
        cig.extend(route)
        if i_end[b] < read_len:
            cig.append(CigarOp(int(read_len - i_end[b]), "S"))
        gpos = int(starts[b]) + int(j0[b])
        chrom, cpos = self._locate(gpos)
        s.rname = chrom
        s.pos = cpos + 1
        s.flag = 0 if strand else 16
        s.cigar = cig
        margin = int(cand.votes[b] - cand.second[b])
        s.mapq = max(0, min(60, 10 * margin + 10))
        s.extra = f"AS:i:{int(score[b])}"
        return s

    def align_pairs(self, pairs: list[tuple[Fastq, Fastq]]) -> list[samio.Sam]:
        return self.finish_pairs(self.align_pairs_async(pairs))

    def align_pairs_async(self, pairs: list[tuple[Fastq, Fastq]]):
        flat: list[Fastq] = []
        for a, bb in pairs:
            flat.append(a)
            flat.append(bb)
        return self.align_batch_async(flat)

    def finish_pairs(self, handle) -> list[samio.Sam]:
        sams = self.finish_batch(handle)
        for i in range(0, len(sams), 2):
            a, b = sams[i], sams[i + 1]
            for x, y, first in ((a, b, True), (b, a, False)):
                x.flag |= 1 | (64 if first else 128)
                if y.flag & 4:
                    x.flag |= 8
                else:
                    x.rnext = "=" if y.rname == x.rname else y.rname
                    x.pnext = y.pos
            if not (a.flag & 4) and not (b.flag & 4) and a.rname == b.rname:
                lo = min(a.pos, b.pos)
                hi = max(a.pos + sum(c.run_length for c in a.cigar
                                     if c.op in "MDN=X"),
                         b.pos + sum(c.run_length for c in b.cigar
                                     if c.op in "MDN=X"))
                tlen = hi - lo
                if tlen < 10000 and ((a.flag & 16) != (b.flag & 16)):
                    a.flag |= 2
                    b.flag |= 2
                a.tlen = tlen if a.pos <= b.pos else -tlen
                b.tlen = -a.tlen
        return sams
