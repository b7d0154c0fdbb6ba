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
