"""Data-parallel execution over several devices of one process: the
counterpart of ``make_mesh`` (``gonomics_tpu/parallel/__init__.py``:27-40)
and ``shard_local_align`` (:117-141).

A mesh is a ("data", "seq") grid of ``torch.device``s in this process, as
a ``jax.sharding.Mesh`` is a grid of one process's local devices: the
"data" axis splits a batch of reads into contiguous slices, one a row of
the grid, whose results come back in batch order, so the output is the
same for any mesh. A device may repeat in the grid, so that one card can
hold several data slices. Processes, ``torch.distributed`` and the rest
of the JAX module wait for later slices of the port (ROADMAP queue 1,
item 7): the prefix-sharded seed lookup (``shard_seed_lookup``, 7.2),
``init_distributed`` and ``merge_shard_files`` (7.3), the pileup
reduction (``shard_pileup_counts``, 7.4), the sequence-sharded Gotoh
wavefront (``shard_seq_*``, 7.5) and ``pipeline_step`` (7.6).
"""

from __future__ import annotations

import numpy as np
import torch

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
