"""Data-parallel and sequence-parallel execution over several devices of
one process, and several processes over loopback or a cluster: the
counterpart of ``gonomics_tpu/parallel/__init__.py`` whole, ``make_mesh``
(:27-40), ``pipeline_step`` (:56-93), ``init_distributed`` (:96-114),
``shard_local_align`` (:117-141), ``shard_seed_lookup`` (:144-207),
``shard_pileup_counts`` (:210-240), ``merge_shard_files`` (:242-269),
``example_step_inputs`` (:272-284), ``shard_seq_affine_align``
(:287-445) and ``shard_seq_affine_score`` (:448-555).

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
shard file a process and ``merge_shard_files`` restores read order.

The sequence-sharded Gotoh aligner splits the lanes s = 0..n of the
anti-diagonal DP over "seq": strip k, lanes [k s_loc, (k + 1) s_loc) cut
at n + 1 (the JAX's S = round_up(n + 1, seq) and s_loc = S / seq; lanes
past n are the JAX's padding, always NEG, and not computed), runs on
``mesh.devices[0][k]`` (the other "data" rows would compute the same and
run nothing), K diagonals a launch of ``ops.wavefront.affine_fwd_strip``.
Where the JAX sends one (B, 2) halo a diagonal to the right neighbour,
strip k hands strip k + 1 its last lane of a whole block, (B, K + 1, 3)
int32, once a block. On the card each strip runs on its own CUDA stream,
block after block, and strip k + 1 takes block t once strip k has written
its edge, so the strips run as a pipeline, on one card that the mesh
repeats as on several.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from .. import NEG, fileio
from ..ops.wavefront import (affine_fwd_strip, initial_state,
                             local_align_full, lowmem_finish,
                             wavefront_align)

# diagonals a launch of the sequence-sharded score forward (the JAX runs
# all n + m in one lax.scan; a launch's edge buffer is (B, K + 1, 3))
SEQ_SCORE_K = 1024


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


def _count_cells(mesh: Mesh, rel, code, valid, shard_span: int,
                 n_code: int) -> torch.Tensor:
    """The (data, seq) cells of a dense count: 1-D events (rel, code,
    valid) of one length, a multiple of ``mesh.shape["data"]``, split into
    "data" contiguous slices, and the positions rel into "seq" slices of
    shard_span. Cell (d, s) counts slice d's valid events whose rel falls
    in span slice s and whose code is in [0, n_code), on its device, with
    ``index_add_`` at the flat int64 index (rel - s shard_span) n_code +
    code (int32 would wrap past ~82 Mbp), the others into a dump slot;
    the cells of a span slice are summed over "data" on the first device.
    The cells that share a device add into one buffer a span slice, so a
    card that the mesh repeats holds seq shard_span n_code * 4 bytes of
    counts, not "data" times that. Returns (seq shard_span, n_code)
    int32 on the mesh's first device."""
    seq_shards = mesh.shape["seq"]
    per = rel.shape[0] // mesh.shape["data"]
    first = mesh.devices[0][0]
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
    return torch.cat(parts).view(seq_shards * shard_span, n_code)


def shard_pileup_counts(mesh: Mesh, *, span: int, n_base: int = 13):
    """Dense pileup scatter-add over the mesh: a function of (rel, code,
    valid), 1-D arrays or tensors of one length, a multiple of
    ``mesh.shape["data"]`` (rel = position - lo, code = base * 2 +
    strand, valid masking the pad), returning (span_pad, 2 n_base) int32
    counts on the mesh's first device, span_pad = span rounded up to a
    multiple of ``mesh.shape["seq"]``.

    The same function as the JAX's one-hot psum, not its steps: the
    events split into "data" contiguous slices and the span into "seq"
    slices of span_pad // seq positions, counted a (data, seq) cell as
    ``_count_cells`` counts them, codes outside [0, 2 n_base) left
    out."""
    seq_shards = mesh.shape["seq"]
    ndata = mesh.shape["data"]
    span_pad = -(-span // seq_shards) * seq_shards

    def run(rel, code, valid):
        rel, code, valid = (torch.as_tensor(x) for x in (rel, code, valid))
        n = rel.shape[0]
        if n % ndata or code.shape[0] != n or valid.shape[0] != n:
            raise ValueError(f"shard_pileup_counts: {n} events for "
                             f"{ndata} data slices")
        return _count_cells(mesh, rel, code, valid, span_pad // seq_shards,
                            n_base * 2)

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


def _first_device_tensor(x, dtype, device) -> torch.Tensor:
    """An array or tensor as a contiguous ``dtype`` tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype).contiguous()


def example_step_inputs(mesh: Mesh, *, B: int, n: int, m: int,
                        genome_len: int, seed: int = 0):
    """Small inputs for ``pipeline_step``: the JAX's draws from
    ``np.random.default_rng(seed)`` in the JAX's order, so the arrays are
    bit for bit the JAX's, as tensors on the mesh's first device: alpha
    (B, n) and beta (B, m) int8 codes 0..3, fin (B, 1) int32 = n + m, pos
    (B, n) int32 in [0, genome_len), base (B, n) int32 0..3, valid (B, n)
    bool, all True. Raises ValueError where B is not a multiple of
    ``mesh.shape["data"]``, where the JAX's sharded placement refuses."""
    if B % mesh.shape["data"]:
        raise ValueError(f"example_step_inputs: B = {B} does not split "
                         f"into {mesh.shape['data']} data slices")
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 4, (B, n)).astype(np.int8)
    beta = rng.integers(0, 4, (B, m)).astype(np.int8)
    fin = np.full((B, 1), n + m, np.int32)
    pos = rng.integers(0, genome_len, (B, n)).astype(np.int32)
    base = rng.integers(0, 4, (B, n)).astype(np.int32)
    valid = np.ones((B, n), bool)
    first = mesh.devices[0][0]
    return tuple(torch.from_numpy(x).to(first)
                 for x in (alpha, beta, fin, pos, base, valid))


def pipeline_step(mesh: Mesh, *, n: int, m: int, genome_len: int, scores,
                  gap_open: int, gap_extend: int, n_base: int = 13):
    """The sharded step: batched affine alignment scores, data-parallel,
    and a genome-position count sharded over "seq" and summed over
    "data". Returns a function of (alpha (B, n), beta (B, m) int8, fin
    (B, 1) or (B,) int32, pos, base (B, L) int, valid (B, L) bool), arrays
    or tensors, giving (scores (B, n + 1), counts (genome_len, n_base))
    int32 on the mesh's first device.

    Scores: the batch splits into ``mesh.shape["data"]`` contiguous
    slices; each runs ``ops.wavefront.wavefront_align(...,
    with_trace=False)`` (the kernel affine_score_diag on the card) on the
    first device of its row, lane s of row b the DP's value at cell (s,
    fin_b - s), as the JAX's; the JAX's lanes past n (its S is a multiple
    of 128) are not kept. Counts: event (b, l) counts at (pos, base) when
    valid, 0 <= pos < genome_len and 0 <= base < n_base (the JAX's one-hot
    gives an out-of-range base no count, and its shard mask an
    out-of-span position none), counted a (data, seq) cell, the span
    cut into seq slices of genome_len / seq, as ``_count_cells`` does.

    Raises ValueError where genome_len is not a multiple of
    ``mesh.shape["seq"]`` (the JAX asserts) and, at a call, where B is not
    a multiple of ``mesh.shape["data"]`` or the shapes disagree (the JAX's
    shard_map refuses)."""
    seq_shards = mesh.shape["seq"]
    ndata = mesh.shape["data"]
    if genome_len % seq_shards:
        raise ValueError(f"pipeline_step: genome_len {genome_len} is not a "
                         f"multiple of the {seq_shards} seq shards")
    span = genome_len // seq_shards
    rows = [row[0] for row in mesh.devices]
    first = rows[0]
    sc = {dev: torch.as_tensor(np.asarray(scores, np.int64),
                               dtype=torch.int32, device=dev)
          for dev in set(rows)}

    def step(alpha, beta, fin, pos, base, valid):
        alpha, beta, fin, pos, base, valid = (
            x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x)) for x in (alpha, beta, fin, pos, base, valid))
        B = alpha.shape[0]
        if (B % ndata or tuple(alpha.shape) != (B, n)
                or tuple(beta.shape) != (B, m) or fin.numel() != B
                or pos.dim() != 2 or pos.shape[0] != B
                or base.shape != pos.shape or valid.shape != pos.shape):
            raise ValueError(
                f"pipeline_step: want alpha ({B}, {n}), beta ({B}, {m}), "
                f"fin of {B} and pos, base, valid of one (B, L) shape with "
                f"B a multiple of {ndata} data slices; got "
                f"{[tuple(x.shape) for x in (alpha, beta, fin, pos, base, valid)]}")
        per = B // ndata
        parts = []
        for d, dev in enumerate(rows):
            a, b, f = (x[d * per:(d + 1) * per].to(dev, non_blocking=True)
                       for x in (alpha, beta, fin))
            res = wavefront_align(a, b, f, sc[dev], gap_open=gap_open,
                                  gap_extend=gap_extend, with_trace=False)
            parts.append(res.to(first, non_blocking=True))
        counts = _count_cells(mesh, pos.reshape(-1), base.reshape(-1),
                              valid.reshape(-1), span, n_base)
        return torch.cat(parts), counts

    return step


def seq_strips(mesh: Mesh, n: int) -> list:
    """The strips of the sequence-sharded aligner for lanes 0..n: (device,
    lo, hi) of each "seq" shard k that holds one of them, lanes [k s_loc,
    min((k + 1) s_loc, n + 1)) with s_loc = ceil((n + 1) / seq), the
    JAX's S / seq, on ``mesh.devices[0][k]``. Trailing shards that hold
    only the JAX's padding lanes have no strip and run nothing."""
    s_loc = -(-(n + 1) // mesh.shape["seq"])
    out = []
    for k, dev in enumerate(mesh.devices[0]):
        lo, hi = k * s_loc, min((k + 1) * s_loc, n + 1)
        if lo < hi:
            out.append((dev, lo, hi))
    return out


def _stream_of(dev: torch.device):
    """A CUDA stream of its own for a strip on a card; None on the CPU."""
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _off_card(x: torch.Tensor, src, side):
    """Before a copy of x, written on stream ``src``, to another device:
    the copy is to run on ``side``, a stream of x's device that waits for
    src. PyTorch runs a copy between devices on the source's current
    stream and makes that stream wait for the destination's queue too;
    on src itself that would hold a strip back until the strips it feeds
    have caught up."""
    if side is not None:
        side.wait_stream(src)
        x.record_stream(side)


def _hand_over(edge: torch.Tensor, src, dst, dev: torch.device, side):
    """Strip k's edge_out, written on stream ``src``, for strip k + 1 on
    stream ``dst`` of device ``dev``. On one device, dst waits for what
    src has queued so far (the block that wrote the edge) and the edge is
    marked as used on dst; across devices it is copied on ``side`` (see
    ``_off_card``)."""
    if edge.device == dev:
        if dst is not None:
            dst.wait_stream(src)
            edge.record_stream(dst)
        return edge
    _off_card(edge, src, side)
    with _on(side), _on(dst):
        return edge.to(dev, non_blocking=True)


def shard_seq_forward(mesh: Mesh, alpha, beta, scores, gap_open: int,
                      gap_extend: int, K: int, fin=None,
                      checkpoints: bool = True):
    """The forward of the sequence-sharded aligner: nb = (n + m - 1) // K
    + 1 blocks of K diagonals over ``seq_strips`` (the JAX's ``fwd_all``,
    parallel/__init__.py:377-399), block-major, each strip a launch of
    ``affine_fwd_strip`` a block on its device, and on the card on a
    stream of its own, ordered only by the edges it takes from the strip
    to its left (see ``_hand_over``).

    alpha (B, n), beta (B, m) int8 tensors; fin (B,) int32 (default n +
    m) the diagonal each pair's capture takes. Returns (checkpoints,
    capture) on the mesh's first device: checkpoints (nb, 3, 2, B, n + 1)
    int32, row t the state at the entry of block t (slot 0 diagonal tK -
    1, slot 1 diagonal tK: the port's lowmem order, the reverse of the
    JAX's stacking at :393-398), equal to ``lowmem_forward``'s, or None
    where ``checkpoints`` is false; capture (3, B, n + 1), M, I and D of
    diagonal fin_b on every lane, NEG where fin_b is none of 1..nb K."""
    B, n = alpha.shape
    m = beta.shape[1]
    K = int(K)
    nb = (n + m - 1) // K + 1
    first = mesh.devices[0][0]
    strips = seq_strips(mesh, n)
    fin = (torch.full((B,), n + m, dtype=torch.int32) if fin is None else
           torch.as_tensor(fin).reshape(B).to(torch.int32))
    inputs = {}
    for dev, _, _ in strips:
        if dev not in inputs:
            inputs[dev] = (
                alpha.to(dev, non_blocking=True),
                beta.to(dev, non_blocking=True),
                torch.as_tensor(scores, dtype=torch.int32).to(dev),
                fin.to(dev, non_blocking=True))
    states = [initial_state(B, n, gap_open, dev)[..., lo:hi].contiguous()
              for dev, lo, hi in strips]
    caps = [torch.full((3, B, hi - lo), NEG, dtype=torch.int32, device=dev)
            for dev, lo, hi in strips]
    first_states = list(states)  # read on the strips' streams: kept alive
    ck = (torch.empty((nb, 3, 2, B, n + 1), dtype=torch.int32, device=first)
          if checkpoints else None)
    # each strip's stream starts after what the caller's streams have
    # queued: the inputs, first states and captures made above, and the
    # last users of the memory the checkpoints took
    streams = [_stream_of(dev) for dev, _, _ in strips]
    # side streams of the copies that leave a strip's device: its edge to
    # the next strip, its checkpoints to the first device (two, so that
    # neither copy waits behind the other)
    edge_sides = [_stream_of(dev) if k + 1 < len(strips)
                  and strips[k + 1][0] != dev else None
                  for k, (dev, _, _) in enumerate(strips)]
    ck_sides = [_stream_of(dev) if checkpoints and dev != first else None
                for dev, _, _ in strips]
    for st in streams:
        if st is not None:
            for dev in {first, *(d for d, _, _ in strips)}:
                st.wait_stream(torch.cuda.current_stream(dev))
    for t in range(nb):
        edge = None
        for k, (dev, lo, hi) in enumerate(strips):
            with _on(streams[k]):
                if ck is not None:
                    _off_card(states[k], streams[k], ck_sides[k])
                    with _on(ck_sides[k]):
                        ck[t, :, :, :, lo:hi].copy_(states[k],
                                                    non_blocking=True)
                a, b, sc, f = inputs[dev]
                states[k], edge = affine_fwd_strip(
                    a, b, states[k], edge, t * K, f, caps[k], lo, sc,
                    gap_open, gap_extend, K)
            if k + 1 < len(strips):
                edge = _hand_over(edge, streams[k], streams[k + 1],
                                  strips[k + 1][0], edge_sides[k])
    # the caller's streams wait for every strip before anything is read
    # or freed
    for dev in {first, *(d for d, _, _ in strips)}:
        if dev.type == "cuda":
            for st in streams + edge_sides + ck_sides:
                if st is not None:
                    torch.cuda.current_stream(dev).wait_stream(st)
    del first_states
    cap = torch.cat([c.to(first, non_blocking=True) for c in caps], dim=2)
    return ck, cap


def shard_seq_affine_align(mesh: Mesh, scores, *, n: int, m: int,
                           gap_open: int, gap_extend: int,
                           checkersize: int = 2048):
    """Sequence-parallel affine alignment with its full traceback: the
    forward lane-sharded over "seq" (``shard_seq_forward``, a checkpoint
    every K = checkersize diagonals), then the lowmem backward (K7 and the
    lowmem walk, ``ops.wavefront.lowmem_finish``) on the mesh's first
    device over those checkpoints, which equal the single-device lowmem
    forward's, so the cigars equal ``affine_gap_lowmem_batch``'s.

    Returns run(alphas (B, n), betas (B, m) int8, arrays or tensors) ->
    list of (score, ops, i0, j0) per pair, the ``affine_gap_lowmem_batch``
    contract. The JAX's ``interpret`` is dropped: the mesh's devices
    decide where it runs."""
    K = int(checkersize)
    first = mesh.devices[0][0]
    sc = torch.as_tensor(np.asarray(scores, np.int64), dtype=torch.int32,
                         device=first)

    def run(alphas, betas):
        alpha = _first_device_tensor(alphas, torch.int8, first)
        beta = _first_device_tensor(betas, torch.int8, first)
        B = alpha.shape[0]
        if tuple(alpha.shape) != (B, n) or tuple(beta.shape) != (B, m):
            raise ValueError(f"shard_seq_affine_align: want ({B}, {n}) and "
                             f"({B}, {m}), got {tuple(alpha.shape)} and "
                             f"{tuple(beta.shape)}")
        ck, cap = shard_seq_forward(mesh, alpha, beta, sc, gap_open,
                                    gap_extend, K)
        return lowmem_finish(ck, cap, alpha, beta, sc, gap_open, gap_extend,
                             K)

    return run


def shard_seq_affine_score(mesh: Mesh, scores, *, n: int, m: int,
                           gap_open: int, gap_extend: int):
    """Sequence-parallel affine-gap scoring: the lane-sharded forward
    (``shard_seq_forward``, blocks of SEQ_SCORE_K diagonals, no
    checkpoints) with each pair's capture on its own diagonal.

    Returns run(alpha_pad (B, n), beta_pad (B, m) int8, fin_d, n_vec (B,
    1) or (B,) int32) -> (B,) int32 on the mesh's first device: max3(M,
    I, D) of cell (n_b, fin_b - n_b), captured at lane n_b of diagonal
    fin_b (the score H[n_b][m_b] where fin_b = n_b + m_b), NEG where n_b
    is not a lane 0..n or fin_b not a diagonal 1..n + m, as the JAX's
    max over lanes and shards gives."""
    K = SEQ_SCORE_K
    first = mesh.devices[0][0]
    sc = torch.as_tensor(np.asarray(scores, np.int64), dtype=torch.int32,
                         device=first)

    def run(alpha_pad, beta_pad, fin_d, n_vec):
        alpha = _first_device_tensor(alpha_pad, torch.int8, first)
        beta = _first_device_tensor(beta_pad, torch.int8, first)
        B = alpha.shape[0]
        if tuple(alpha.shape) != (B, n) or tuple(beta.shape) != (B, m):
            raise ValueError(f"shard_seq_affine_score: want ({B}, {n}) and "
                             f"({B}, {m}), got {tuple(alpha.shape)} and "
                             f"{tuple(beta.shape)}")
        fin = _first_device_tensor(fin_d, torch.int32, first).reshape(B)
        nv = _first_device_tensor(n_vec, torch.int64, first).reshape(B)
        _, cap = shard_seq_forward(mesh, alpha, beta, sc, gap_open,
                                   gap_extend, K, fin=fin, checkpoints=False)
        lane = nv.clamp(0, n)[None, :, None].expand(3, B, 1)
        best = cap.gather(2, lane)[:, :, 0].amax(0)
        ok = (nv >= 0) & (nv <= n) & (fin >= 1) & (fin <= n + m)
        return torch.where(ok, best, NEG).to(torch.int32)

    return run
