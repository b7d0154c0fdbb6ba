"""Pileup: per-position base counts from coordinate-sorted reads: the
whole of ``gonomics_tpu/pileup.py`` (``Pile`` :33 to ``_dense_from_runs``
:320) on the port's host copies.

Counts accumulate into a dense (positions x 13 bases x 2 strands) count
matrix per chromosome, over the covered span only; insertions and
deletions go to sparse side tables, as the reference's InsCount/DelCount
maps. Without a mesh the counts are made on the host (numpy, or the
native scatter of ``native/seqio.cpp``), as the JAX does. With a mesh
(``parallel.Mesh``) the dense scatter-add runs on the mesh's devices
(``parallel.shard_pileup_counts``: events split over "data", the span over
"seq", summed over "data"), and the result is the same. From SAM text
(``pileup_dense_from_sam_path``) the mesh path expands the native
tokenizer's runs to per-base events on the mesh's first device, where
the JAX expands them in numpy, and also gives the strand sums and depths
that the native scatter gives.

Semantics kept for byte-exact downstream output:
  - reads with unmapped cigars skipped, terminal insertions soft-clipped
    (sclipTerminalIns, pileup.go:432)
  - "forward" = unpaired or first-in-pair (NOT strand; pileup.go:229)
  - deletions add Gap counts at every deleted position and a DelCount at
    the 5'-most base; insertions record at refPos-1
  - piles emitted in (refIdx, pos) order for touched positions only
    (includeNoData=False) after pile filters
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import dna
from .io import cigar as samcigar
from .io.chrom_info import ChromInfo
from .io.sam import Header, Sam, is_forward_read, is_paired


@dataclass
class Pile:
    ref_idx: int = -1
    pos: int = 0  # 1-based
    count_f: np.ndarray = field(default_factory=lambda: np.zeros(13, np.int64))
    count_r: np.ndarray = field(default_factory=lambda: np.zeros(13, np.int64))
    ins_count_f: dict = field(default_factory=dict)
    ins_count_r: dict = field(default_factory=dict)
    del_count_f: dict = field(default_factory=dict)
    del_count_r: dict = field(default_factory=dict)


def calc_depth(p: Pile) -> int:
    """callVariants calcDepth: all base counts (incl Gap) + insertions."""
    return int(p.count_f.sum() + p.count_r.sum()
               + sum(p.ins_count_f.values()) + sum(p.ins_count_r.values()))


def _sclip_terminal_ins(cig: list[samcigar.CigarOp]) -> list[samcigar.CigarOp]:
    cig = [samcigar.CigarOp(c.run_length, c.op) for c in cig]
    if not cig or cig[0].op == "*":
        return cig
    if cig[0].op == "I":
        cig[0].op = "S"
    if cig[-1].op == "I":
        cig[-1].op = "S"
    if len(cig) >= 2 and cig[0].op == "S" and cig[1].op == "I":
        cig[1].op = "S"
        cig[1].run_length += cig[0].run_length
        cig = cig[1:]
    if len(cig) >= 2 and cig[-1].op == "S" and cig[-2].op == "I":
        cig[-2].op = "S"
        cig[-2].run_length += cig[-1].run_length
        cig = cig[:-1]
    return cig


class _ChromCounts:
    """Dense counts over the covered span only (not the whole chromosome):
    scatter targets are offset by the first read position."""

    def __init__(self, size: int):
        self.size = size
        self.counts: np.ndarray | None = None
        # native-path extras: strand-summed (span, 13) matrix and
        # per-position base depth, filled in the same C scatter pass
        self.cnt2: np.ndarray | None = None
        self.depth_arr: np.ndarray | None = None
        self.lo = 0
        self.ins: dict[int, list[dict]] = {}
        self.dels: dict[int, list[dict]] = {}

    def _ins_maps(self, pos: int) -> list[dict]:
        if pos not in self.ins:
            self.ins[pos] = [{}, {}]
        return self.ins[pos]

    def _del_maps(self, pos: int) -> list[dict]:
        if pos not in self.dels:
            self.dels[pos] = [{}, {}]
        return self.dels[pos]


def pileup(reads: list[Sam], header: Header,
           read_filters=None, pile_filters=None,
           include_no_data: bool = False, mesh=None) -> list[Pile]:
    """sam.GoPileup equivalent, eager over a read list.

    mesh: optional ``parallel.Mesh`` ("data", "seq"); when given, the
    dense base-count scatter-add runs on the mesh's devices (events split
    over "data", the span over "seq", summed over "data"; see
    ``parallel.shard_pileup_counts``). Indel side tables stay on the host
    (sparse, rare). The output is the host path's."""
    chrom_data = pileup_dense(reads, header, read_filters, mesh=mesh)
    out: list[Pile] = []
    for refidx in sorted(chrom_data):
        cd = chrom_data[refidx]
        touched = set((np.nonzero(cd.counts.any(axis=(1, 2)))[0]
                       + cd.lo).tolist())
        touched.update(cd.ins.keys())
        for p in sorted(touched):
            pile = pile_from_dense(cd, refidx, int(p))
            if pile_filters and not all(f(pile) for f in pile_filters):
                continue
            out.append(pile)
    return out


def pile_from_dense(cd: "_ChromCounts", refidx: int, p: int) -> Pile:
    pile = Pile(ref_idx=refidx, pos=p,
                count_f=cd.counts[p - cd.lo, :, 0].astype(np.int64),
                count_r=cd.counts[p - cd.lo, :, 1].astype(np.int64))
    if p in cd.ins:
        pile.ins_count_f, pile.ins_count_r = cd.ins[p]
    if p in cd.dels:
        pile.del_count_f, pile.del_count_r = cd.dels[p]
    return pile


def pileup_dense(reads: list[Sam], header: Header, read_filters=None,
                 mesh=None) -> dict[int, "_ChromCounts"]:
    """The dense form of pileup(): per-chromosome (span, 13, 2) count
    arrays and sparse indel side tables, before any Pile is made: what
    callVariants' vectorized candidate prescreen reads."""
    if header.sort_order[0] != "coordinate":
        raise ValueError("input sam/bam must be coordinate sorted")
    refmap = {c.name: c for c in header.chroms}
    chrom_data: dict[int, _ChromCounts] = {}

    # gather dense scatter runs in bulk (one (start, len, fwd, refidx)
    # tuple per M/D cigar run; the arrays are built in one vectorized
    # repeat/arange pass — per-op numpy allocations dominated at scale),
    # indels into side tables
    starts_l: list[int] = []
    lens_l: list[int] = []
    fwd_l: list[int] = []
    ridx_l: list[int] = []
    base_l: list[np.ndarray] = []
    _gap_run = np.full(512, dna.GAP, np.int8)

    for s in reads:
        if samcigar.is_unmapped(s.cigar):
            continue
        if read_filters and not all(f(s) for f in read_filters):
            continue
        cig = _sclip_terminal_ins(s.cigar)
        info = refmap[s.rname]
        refidx = info.order
        if refidx not in chrom_data:
            chrom_data[refidx] = _ChromCounts(info.size)
        cd = chrom_data[refidx]
        fwd = 0 if (not is_paired(s) or is_forward_read(s)) else 1

        ref_pos = s.pos
        seq_pos = 0
        for c in cig:
            if c.op in "M=X":
                starts_l.append(ref_pos)
                lens_l.append(c.run_length)
                fwd_l.append(fwd)
                ridx_l.append(refidx)
                base_l.append(s.seq[seq_pos:seq_pos + c.run_length])
                ref_pos += c.run_length
                seq_pos += c.run_length
            elif c.op == "D":
                d = cd._del_maps(ref_pos)[fwd]
                d[c.run_length] = d.get(c.run_length, 0) + 1
                starts_l.append(ref_pos)
                lens_l.append(c.run_length)
                fwd_l.append(fwd)
                ridx_l.append(refidx)
                base_l.append(_gap_run[:c.run_length]
                              if c.run_length <= len(_gap_run)
                              else np.full(c.run_length, dna.GAP, np.int8))
                ref_pos += c.run_length
            elif c.op == "I":
                key = dna.to_string(s.seq[seq_pos:seq_pos + c.run_length])
                m = cd._ins_maps(ref_pos - 1)[fwd]
                m[key] = m.get(key, 0) + 1
                seq_pos += c.run_length
            else:
                if samcigar.consumes_reference(c.op):
                    ref_pos += c.run_length
                if samcigar.consumes_query(c.op):
                    seq_pos += c.run_length

    if starts_l:
        lens = np.asarray(lens_l, np.int64)
        starts = np.asarray(starts_l, np.int64)
        total = int(lens.sum())
        csum = np.concatenate(([0], np.cumsum(lens)[:-1]))
        intra = np.arange(total) - np.repeat(csum, lens)
        pos = np.repeat(starts, lens) + intra
        base = np.concatenate(base_l).astype(np.int64)
        strand = np.repeat(np.asarray(fwd_l, np.int64), lens)
        ridx = np.repeat(np.asarray(ridx_l, np.int64), lens)
        for refidx, cd in chrom_data.items():
            m = ridx == refidx
            pm = pos[m]
            ins_pos = list(cd.ins.keys())
            lo = int(min(pm.min(), min(ins_pos, default=pm.min())))
            hi = int(max(pm.max(), max(ins_pos, default=pm.max())))
            cd.lo = lo
            span = hi - lo + 1
            if mesh is not None:
                cd.counts = _device_counts(mesh, pm - lo, base[m],
                                           strand[m], span)
            else:
                cd.counts = np.zeros((span, 13, 2), np.int32)
                np.add.at(cd.counts, (pm - lo, base[m], strand[m]), 1)

    for cd in chrom_data.values():
        if cd.counts is None:
            cd.counts = np.zeros((1, 13, 2), np.int32)
            cd.lo = min(cd.ins.keys(), default=1)
    return chrom_data


def _device_counts(mesh, rel: np.ndarray, base: np.ndarray,
                   strand: np.ndarray, span: int) -> np.ndarray:
    """Sharded scatter-add of (rel, base, strand) events -> (span, 13, 2)
    int32 on the host."""
    import torch

    code = base.astype(np.int64) * 2 + strand
    return _mesh_counts(mesh, torch.from_numpy(rel.astype(np.int64)),
                        torch.from_numpy(code), span).cpu().numpy()


def _mesh_counts(mesh, rel, code, span: int):
    """``parallel.shard_pileup_counts`` of the events (rel, code), 1-D
    int64 tensors on one device, padded there to a multiple of the mesh's
    "data" slices (the pad marked invalid); the result cut to span,
    (span, 13, 2) on the mesh's first device."""
    import torch

    from .parallel import shard_pileup_counts

    ndata = mesh.shape["data"]
    n = rel.shape[0]
    n_pad = max(ndata, -(-n // ndata) * ndata)
    pad = n_pad - n
    valid = torch.arange(n_pad, device=rel.device) < n
    rel = torch.nn.functional.pad(rel, (0, pad))
    code = torch.nn.functional.pad(code, (0, pad))
    counts = shard_pileup_counts(mesh, span=span)(rel, code, valid)
    return counts[:span].view(span, 13, 2)


def sync_pileups(samples: list[list[Pile]]):
    """sam.GoSyncPileups equivalent: yields per-position [Pile] slices with
    ref_idx == -1 marking samples without data at the position."""
    iters = [iter(s) for s in samples]
    buf: list[Pile | None] = [next(it, None) for it in iters]
    while any(b is not None for b in buf):
        coords = [(b.ref_idx, b.pos) for b in buf if b is not None]
        mn = min(coords)
        row = []
        for i, b in enumerate(buf):
            if b is not None and (b.ref_idx, b.pos) == mn:
                row.append(b)
                buf[i] = next(iters[i], None)
            else:
                row.append(Pile(ref_idx=-1))
        yield row


def sum_piles(piles: list[Pile]) -> Pile:
    """callVariants sumPiles (testVariant.go:166)."""
    ans = Pile(ref_idx=-1)
    for p in piles:
        if ans.ref_idx == -1 and p.ref_idx != -1:
            ans.ref_idx = p.ref_idx
            ans.pos = p.pos
        ans.count_f = ans.count_f + p.count_f
        ans.count_r = ans.count_r + p.count_r
        for k, v in p.ins_count_f.items():
            ans.ins_count_f[k] = ans.ins_count_f.get(k, 0) + v
        for k, v in p.ins_count_r.items():
            ans.ins_count_r[k] = ans.ins_count_r.get(k, 0) + v
        for k, v in p.del_count_f.items():
            ans.del_count_f[k] = ans.del_count_f.get(k, 0) + v
        for k, v in p.del_count_r.items():
            ans.del_count_r[k] = ans.del_count_r.get(k, 0) + v
    return ans


def pileup_dense_from_sam_path(path: str, header: Header, min_mapq: int,
                               mesh=None,
                               nthreads: int = 0) -> dict[int, "_ChromCounts"]:
    """pileup_dense straight from a SAM text file through the native
    tokenizer (native/seqio.cpp sam_scatter): one C pass builds the
    scatter runs and indel events without making Sam objects. BAM or gzip
    input, or a missing native library, takes the Python reader. Read
    filters: mapq >= min_mapq and unmapped skipped (callVariants')."""
    from . import fileio, native
    from .io import sam as samio

    if header.sort_order[0] != "coordinate":
        raise ValueError("input sam/bam must be coordinate sorted")
    text = None
    if native.available():
        with open(path, "rb") as f:
            head = f.read(2)
        if head != fileio.GZIP_MAGIC:
            with open(path, "rb") as f:
                text = f.read()
    if text is not None:
        res = native.sam_scatter(text, [c.name for c in header.chroms],
                                 min_mapq)
        if res is not None:
            return _dense_from_runs(header, *res, mesh=mesh,
                                    nthreads=nthreads)
    _, reads = samio.read(path)
    return pileup_dense(reads, header,
                        [lambda s: s.mapq >= min_mapq], mesh=mesh)


def _dense_from_runs(header: Header, starts, lens, fwds, ridx, bases,
                     del_ev, ins_ev, ins_str: bytes, mesh=None,
                     nthreads: int = 0) -> dict[int, "_ChromCounts"]:
    chrom_data: dict[int, _ChromCounts] = {}

    def cd_for(refidx: int) -> _ChromCounts:
        if refidx not in chrom_data:
            chrom_data[refidx] = _ChromCounts(header.chroms[refidx].size)
        return chrom_data[refidx]

    for refidx, pos, dlen, fwd in del_ev.tolist():
        d = cd_for(refidx)._del_maps(pos)[fwd]
        d[dlen] = d.get(dlen, 0) + 1
    for refidx, pos, fwd, off, slen in ins_ev.tolist():
        key = ins_str[off:off + slen].decode()
        m = cd_for(refidx)._ins_maps(pos)[fwd]
        m[key] = m.get(key, 0) + 1

    if len(starts):
        from . import native

        run_ends = starts.astype(np.int64) + lens.astype(np.int64)
        on_mesh = None   # the runs' bases and offsets on the mesh, once
        for refidx in np.unique(ridx):
            cd = cd_for(int(refidx))
            m = ridx == refidx
            ins_pos = list(cd.ins.keys())
            rmin = int(starts[m].min())
            rmax = int(run_ends[m].max()) - 1
            lo = int(min(rmin, min(ins_pos, default=rmin)))
            hi = int(max(rmax, max(ins_pos, default=rmax)))
            cd.lo = lo
            span = hi - lo + 1
            if mesh is not None:
                if on_mesh is None:
                    on_mesh = _runs_on_mesh(mesh, bases, lens)
                cd.counts, cd.cnt2, cd.depth_arr = _device_counts_from_runs(
                    mesh, on_mesh, starts, lens, fwds, np.nonzero(m)[0], lo,
                    span)
                continue
            got = native.runs_to_counts(starts, lens, fwds, ridx, bases,
                                        int(refidx), lo, span,
                                        nthreads=nthreads)
            if got is not None:
                cd.counts, cd.cnt2, cd.depth_arr = got
                continue
            # without the native library: numpy expansion to flat events
            lens64 = lens[m].astype(np.int64)
            total = int(lens64.sum())
            csum = np.concatenate(([0], np.cumsum(lens64)[:-1]))
            intra = np.arange(total) - np.repeat(csum, lens64)
            pm = np.repeat(starts[m].astype(np.int64), lens64) + intra
            boff = np.concatenate(([0], np.cumsum(lens.astype(np.int64))))
            bsel = np.concatenate(
                [bases[boff[i]:boff[i + 1]]
                 for i in np.nonzero(m)[0]]) if total else bases[:0]
            strand = np.repeat(fwds[m].astype(np.int64), lens64)
            cd.counts = np.zeros((span, 13, 2), np.int32)
            np.add.at(cd.counts, (pm - lo, bsel.astype(np.int64), strand), 1)

    for cd in chrom_data.values():
        if cd.counts is None:
            cd.counts = np.zeros((1, 13, 2), np.int32)
            cd.lo = min(cd.ins.keys(), default=1)
    return chrom_data


def _runs_on_mesh(mesh, bases: np.ndarray, lens: np.ndarray):
    """The runs' bases (int8) and each run's offset into them (int64) on
    the mesh's first device, uploaded once for all chromosomes."""
    import torch

    dev = mesh.devices[0][0]
    off = np.concatenate(([0], np.cumsum(lens.astype(np.int64))[:-1]))
    return (torch.from_numpy(np.ascontiguousarray(bases, np.int8)).to(dev),
            torch.from_numpy(off).to(dev))


def _device_counts_from_runs(mesh, on_mesh, starts, lens, fwds,
                             run_idx: np.ndarray, lo: int, span: int):
    """The mesh path of ``_dense_from_runs`` for one chromosome's runs
    (``run_idx`` into starts, lens and fwds): the runs expand to per-base
    events on the mesh's first device (``repeat_interleave``) rather than
    in numpy, the same events in the same order, counted by
    ``_mesh_counts``. Returns (counts (span, 13, 2) int32, cnt2 (span, 13)
    int32, depth (span,) int32) on the host: the strand sums and depth
    that the native scatter also gives, so that callVariants' prescreen
    takes the same native pass on either path."""
    import torch

    dev = mesh.devices[0][0]
    bases_t, off_t = on_mesh

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)

    run_len = up(lens[run_idx])
    run_of = torch.repeat_interleave(
        torch.arange(len(run_idx), device=dev), run_len,
        output_size=int(lens[run_idx].astype(np.int64).sum()))
    intra = (torch.arange(run_of.shape[0], device=dev)
             - (torch.cumsum(run_len, 0) - run_len)[run_of])
    rel = (up(starts[run_idx]) - lo)[run_of] + intra
    base = bases_t[off_t[up(run_idx)][run_of] + intra].to(torch.int64)
    code = base * 2 + up(fwds[run_idx])[run_of]
    counts = _mesh_counts(mesh, rel, code, span)
    cnt2 = counts.sum(2, dtype=torch.int32)
    depth = cnt2.sum(1, dtype=torch.int32)
    return counts.cpu().numpy(), cnt2.cpu().numpy(), depth.cpu().numpy()
