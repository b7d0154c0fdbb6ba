"""PyTorch + CUDA port of gonomics_tpu for one NVIDIA H100.

Mirrors ``gonomics_tpu/`` module by module; the JAX package stays the
reference that every ported function is held against. This package
imports neither JAX nor anything of ``gonomics_tpu``: the host modules it
needs are copied into it.

Devices are explicit. Entry points take ``device=None``, which means the
card (``"cuda"``); they run on the CPU only when the caller passes
``device="cpu"``, and raise when the card is asked for and absent.
"""

from __future__ import annotations

import torch

NEG = -(2 ** 30)  # gonomics_tpu/ops/wavefront.py:38; int32-safe against adds


def resolve_device(device=None) -> torch.device:
    """The one place that turns ``None`` into the card: ``None`` means
    ``"cuda"``; a CUDA device without a usable card raises RuntimeError
    instead of carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class DeviceResult:
    """A uint8 result on its way to the host: on the card, a non-blocking
    copy into pinned memory that ``done`` records; on the CPU, the array
    itself. ``numpy()`` waits for the copy."""

    def __init__(self, res: torch.Tensor):
        self.done = None
        if res.device.type == "cuda":
            self.host = torch.empty(res.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(res, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = res

    def numpy(self):
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()
