"""Data-parallel execution over several devices of one process, and
several processes over loopback or a cluster: the counterpart of
``gonomics_tpu/parallel/__init__.py``'s ``make_mesh`` (:27-40),
``init_distributed`` (:96-114), ``shard_local_align`` (:117-141),
``shard_seed_lookup`` (:144-207), ``shard_pileup_counts`` (:210-240) and
``merge_shard_files`` (:242-269).

A mesh is a ("data", "seq") grid of ``torch.device``s in this process, as
a ``jax.sharding.Mesh`` is a grid of one process's local devices: the
"data" axis splits a batch of reads into contiguous slices, one a row of
the grid, whose results come back in batch order, so the output is the
same for any mesh. A device may repeat in the grid, so that one card can
hold several data slices. The prefix-sharded seed index puts one chunk
of the sorted (code, pos) table on each row. The pileup count splits its
events over "data" and the genome span over "seq". Processes meet
through ``init_distributed`` (``torch.distributed`` on gloo), one a
host, each with its host's mesh; ``gsw align --multihost`` writes a
shard file a process and ``merge_shard_files`` restores read order. The
rest of the JAX module waits for later slices of the port (ROADMAP queue
1, item 7): the sequence-sharded Gotoh wavefront (``shard_seq_*``, 7.5)
and ``pipeline_step`` (7.6).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import fileio
from ..ops.wavefront import local_align_full


def normal_device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ("data", "seq") grid of devices: ``devices[d][s]``, and ``shape``
    {"data": d, "seq": s} as ``jax.sharding.Mesh.shape`` has it."""

    def __init__(self, devices: list[list[torch.device]]):
        self.devices = [[normal_device(d) for d in row] for row in devices]
        self.shape = {"data": len(self.devices),
                      "seq": len(self.devices[0])}


def make_mesh(n_devices: int | None = None, data: int | None = None,
              seq: int | None = None, devices=None) -> Mesh:
    """A ("data", "seq") mesh over the first n_devices of ``devices``
    (default: every CUDA device), with the JAX ``make_mesh``'s rule for
    the axes: without ``data``, seq = ``seq`` or 2 where n_devices is even
    and above 1, else 1, and data = n_devices // seq; with ``data`` alone,
    seq = n_devices // data. Raises RuntimeError where there is no CUDA
    device and ``devices`` is not given, and ValueError where the grid
    needs more devices than there are."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu'] * 8)")
    devices = [normal_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if data is None:
        seq = seq or (2 if n_devices % 2 == 0 and n_devices > 1 else 1)
        data = n_devices // seq
    elif seq is None:
        seq = n_devices // data
    if data < 1 or seq < 1 or data * seq > len(devices):
        raise ValueError(f"make_mesh: a ({data}, {seq}) grid over "
                         f"{len(devices)} devices")
    return Mesh([devices[k * seq:(k + 1) * seq] for k in range(data)])


def shard_local_align(mesh: Mesh, scores, *, n: int, m: int, gap: int):
    """Data-parallel ``local_align_full`` over the mesh's "data" axis: a
    function of (alpha (B, n), beta (B, m), n_vec, m_vec (B,)) that splits
    the batch into ``mesh.shape["data"]`` contiguous slices in batch
    order (the first B mod data slices a row longer; empty where B <
    data), runs ``local_align_full`` on each slice on the first device of
    its row of the mesh (the row's other devices, the "seq" replicas,
    would compute the same and run nothing), and returns its six outputs
    concatenated in batch order on the mesh's first device. Each slice
    gets its own copy of its inputs where its device is another, and its
    own outputs: the walk's trace is its own allocation. Copies between
    devices are ordered on the streams as PyTorch orders them."""
    rows = [row[0] for row in mesh.devices]
    first = rows[0]
    sc = {dev: torch.as_tensor(np.asarray(scores, np.int64),
                               dtype=torch.int32, device=dev)
          for dev in set(rows)}

    def run(alpha, beta, n_vec, m_vec):
        B = alpha.shape[0]
        if tuple(alpha.shape) != (B, n) or tuple(beta.shape) != (B, m):
            raise ValueError(f"shard_local_align: want ({B}, {n}) and ({B}, "
                             f"{m}), got {tuple(alpha.shape)} and "
                             f"{tuple(beta.shape)}")
        sizes = [B // len(rows) + (k < B % len(rows))
                 for k in range(len(rows))]
        cuts = [0, *np.cumsum(sizes).tolist()]
        parts = []
        for dev, lo, hi in zip(rows, cuts[:-1], cuts[1:]):
            ins = [x[lo:hi].to(dev, non_blocking=True)
                   for x in (alpha, beta, n_vec, m_vec)]
            parts.append(local_align_full(*ins, sc[dev], gap))
        return tuple(torch.cat([p[k].to(first, non_blocking=True)
                                for p in parts])
                     for k in range(6))

    return run


# flipping the sign bit maps unsigned 64-bit order onto signed order
_SIGN = np.int64(-(1 << 63))


def code_keys(codes: np.ndarray) -> torch.Tensor:
    """uint64 seed codes as int64 keys in the same order, for torch, which
    has no usable uint64 order: the sign bit flipped, so that 0 maps to
    -2^63 and the pad code 2^63 to 0. Real codes (< 2^62) and the
    bad-window code 2^62 stay below the pad, as they are unsigned."""
    return torch.from_numpy(np.ascontiguousarray(codes).view(np.int64)
                            ^ _SIGN)


def place_index_chunks(mesh: Mesh, chunk_codes: np.ndarray,
                       chunk_pos: np.ndarray):
    """The chunks of ``read_align.split_index_prefix`` ((data, L) uint64
    codes and positions) on the mesh: chunk k's keys (``code_keys``) and
    positions on the first device of row k of the "data" axis, as
    ``shard_local_align`` places its slices. Returns (keys, pos), each a
    list of one 1-D tensor a row."""
    rows = [row[0] for row in mesh.devices]
    if chunk_codes.shape[0] != len(rows):
        raise ValueError(f"place_index_chunks: {chunk_codes.shape[0]} "
                         f"chunks for {len(rows)} data rows")
    keys = [code_keys(c).to(dev) for c, dev in zip(chunk_codes, rows)]
    pos = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
           for p, dev in zip(chunk_pos, rows)]
    return keys, pos


def shard_seed_lookup(mesh: Mesh, *, max_hits: int):
    """Prefix-sharded k-mer index lookup: a function of (keys, pos, query)
    with ``keys`` and ``pos`` from ``place_index_chunks`` and ``query`` a
    (B, K) int64 tensor of ``code_keys``, returning hitpos (B, K, H) in
    the chunks' position dtype and valid (B, K, H) bool on the mesh's
    first device, in query order, H = max_hits.

    As the JAX lookup: each row's device finds every query's run in its
    chunk (``torch.searchsorted`` left and right), truncates it to H hits
    and gathers their positions, 0 where invalid; the rows' hits and
    valid counts are summed on the first device, and hitpos is -1 where
    no row had a hit. The chunks split the table between distinct codes,
    so one row at most holds a query's run and the result equals the
    replicated table's lookup (the pad code, which no read gives, sums
    to position 0 where any chunk holds pads)."""
    H = max_hits
    rows = [row[0] for row in mesh.devices]
    first = rows[0]

    def run(keys, pos, query):
        shape = (*query.shape, H)
        q = query.reshape(-1)
        hits = valid = None
        for dev, ck, cp in zip(rows, keys, pos):
            qd = q.to(dev, non_blocking=True)
            lo = torch.searchsorted(ck, qd)
            hi = torch.minimum(torch.searchsorted(ck, qd, right=True),
                               lo + H)
            take = lo[:, None] + torch.arange(H, device=dev)
            ok = take < hi[:, None]
            got = torch.where(ok, cp[take.clamp_(max=ck.numel() - 1)], 0)
            got, ok = got.to(first), ok.to(first, torch.int32)
            hits = got if hits is None else hits + got
            valid = ok if valid is None else valid + ok
        valid = valid > 0
        return (torch.where(valid, hits, -1).reshape(shape),
                valid.reshape(shape))

    return run


def shard_pileup_counts(mesh: Mesh, *, span: int, n_base: int = 13):
    """Dense pileup scatter-add over the mesh: a function of (rel, code,
    valid), 1-D arrays or tensors of one length, a multiple of
    ``mesh.shape["data"]`` (rel = position - lo, code = base * 2 +
    strand, valid masking the pad), returning (span_pad, 2 n_base) int32
    counts on the mesh's first device, span_pad = span rounded up to a
    multiple of ``mesh.shape["seq"]``.

    The same function as the JAX's one-hot psum, not its steps: the
    events split into "data" contiguous slices and the span into "seq"
    slices of span_pad // seq positions; cell (d, s) counts slice d's
    valid events whose rel falls in span slice s, and whose code is in
    [0, 2 n_base), on its device with ``index_add_`` at the flat int64
    index rel * 2 n_base + code (int32 would wrap past ~82 Mbp), and the
    cells of a span slice are summed over "data" on the first device. The
    cells that share a device add into one buffer a span slice, so a card
    that the mesh repeats holds span_pad * 2 n_base * 4 bytes of counts,
    not "data" times that."""
    seq_shards = mesh.shape["seq"]
    ndata = mesh.shape["data"]
    span_pad = -(-span // seq_shards) * seq_shards
    shard_span = span_pad // seq_shards
    n_code = n_base * 2
    first = mesh.devices[0][0]

    def run(rel, code, valid):
        rel, code, valid = (torch.as_tensor(x) for x in (rel, code, valid))
        n = rel.shape[0]
        if n % ndata or code.shape[0] != n or valid.shape[0] != n:
            raise ValueError(f"shard_pileup_counts: {n} events for "
                             f"{ndata} data slices")
        per = n // ndata
        bufs: dict = {}   # (device, span slice) -> flat counts + a dump
        for d, row in enumerate(mesh.devices):
            on: dict = {}
            for s, dev in enumerate(row):
                if dev not in on:
                    on[dev] = [x[d * per:(d + 1) * per].to(
                        dev, non_blocking=True) for x in (rel, code, valid)]
                r, c, v = on[dev]
                r = r.to(torch.int64) - s * shard_span
                c = c.to(torch.int64)
                ok = (v.to(torch.bool) & (r >= 0) & (r < shard_span)
                      & (c >= 0) & (c < n_code))
                dump = shard_span * n_code   # invalid events land here
                idx = torch.where(ok, r * n_code + c, dump)
                buf = bufs.get((dev, s))
                if buf is None:
                    buf = bufs[(dev, s)] = torch.zeros(
                        dump + 1, dtype=torch.int32, device=dev)
                buf.index_add_(0, idx, torch.ones(
                    idx.shape, dtype=torch.int32, device=dev))
        parts = []
        for s in range(seq_shards):
            tot = None
            for (dev, s2), buf in bufs.items():
                if s2 == s:
                    part = buf[:-1].to(first, non_blocking=True)
                    tot = part if tot is None else tot + part
            parts.append(tot)
        return torch.cat(parts).view(span_pad, n_code)

    return run


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join this process to a process group: one process a host, each
    running the same program with its host's devices as its mesh.

    With every argument None the group comes from the environment
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, as ``torchrun`` sets them), the counterpart of the
    pod auto-detection of ``jax.distributed.initialize()``. A
    ``host:port`` address becomes ``tcp://host:port``; an address with a
    scheme (``tcp://``, ``file://``) is used as it stands.

    The backend is gloo: the group's one collective is the barrier
    before the shard files are merged (the JAX CLI's
    ``sync_global_devices``), which needs no card, and NCCL refuses two
    ranks on one card, as a one-card machine runs them. Call once a
    process; ``dist.destroy_process_group()`` ends it."""
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def process_count() -> int:
    """The processes of the group, 1 where none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group, 0 where none is initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def merge_shard_files(out_path: str, shard_paths: list[str],
                      header_lines: list[str] | None = None) -> None:
    """The multi-host merge of SAM or giraf shards: shard h holds the
    records of batches h, h + H, h + 2H, ... of H processes, each batch
    ended by a ``#BATCH`` line; the batches are written back round robin
    under the header lines, which restores the single-process output
    byte for byte."""
    readers = [fileio.easy_open(p) for p in shard_paths]
    with fileio.easy_create(out_path) as out:
        if header_lines:
            for ln in header_lines:
                out.write(ln + "\n")
        done = [False] * len(readers)
        while not all(done):
            for i, r in enumerate(readers):
                if done[i]:
                    continue
                wrote_any = False
                for ln in r:
                    if ln.startswith("#BATCH"):
                        wrote_any = True
                        break
                    out.write(ln)
                if not wrote_any:
                    done[i] = True
    for r in readers:
        r.close()
