"""Transcription-factor position matrices and the genome scan: the
subset of ``gonomics_tpu/motif.py`` that the scan uses
(``PositionMatrix`` :26, ``read_jaspar`` :55) and the counterpart of its
device scan ``scan_scores_jax`` (:174).

A matrix is a (4, L) float64 array, rows A, C, G, T. The scan scores
every window of L bases as the correlation of the one-hot bases with the
matrix cast to float32; a window that holds any code >= 4 (N, a lowercase
base or a gap) scores -inf, as the JAX scan's mask does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import fileio, resolve_device

FREQUENCY, PROBABILITY, WEIGHT = "Frequency", "Probability", "Weight"


@dataclass
class PositionMatrix:
    id: str = ""
    name: str = ""
    type: str = FREQUENCY
    mat: np.ndarray = field(default_factory=lambda: np.zeros((4, 0)))


def read_jaspar(filename: str, type_: str) -> list[PositionMatrix]:
    """The matrices of a JASPAR file: a '>' header line and four rows of
    counts a matrix (motif.ReadJaspar)."""
    lines = [ln for ln in fileio.read(filename) if ln]
    if len(lines) % 5:
        raise ValueError("JASPAR file line count must be a multiple of 5")
    out = []
    seen = set()
    for i in range(0, len(lines), 5):
        header = lines[i]
        if not header.startswith(">"):
            raise ValueError("Pfm header line must begin with '>'")
        fields = header[1:].split()
        pm = PositionMatrix(id=fields[0],
                            name=fields[1] if len(fields) > 1 else "",
                            type=type_)
        if pm.id in seen:
            raise ValueError(f"duplicate motif ID {pm.id}")
        seen.add(pm.id)
        rows = []
        for line in lines[i + 1:i + 5]:
            vals = line.replace("[", " ").replace("]", " ").split()[1:]
            rows.append([float(v) for v in vals])
        pm.mat = np.array(rows, np.float64)
        out.append(pm)
    return out


def scan_scores_device(pm: PositionMatrix, seq, device=None) -> torch.Tensor:
    """The score of every window of L = len(pm.mat[0]) bases of ``seq``
    (base codes, a numpy array or a tensor) on ``device`` (None: the
    card): a float32 tensor of len(seq) - L + 1 scores, score i the sum
    over j of float32(mat)[seq[i + j], j], -inf where any code of the
    window is >= 4. The JAX function's one-hot convolution of the same
    float32 matrix, as a gather-sum: the terms are added in float64 and
    the sum rounded once to float32, so a score is the float32 nearest
    the exact sum of its terms (the JAX's float32 accumulation may be an
    ulp or a few from it), the same on the card and the CPU. Not a cuDNN
    convolution, which on the card defaults to TF32 and would round the
    matrix to 10 mantissa bits."""
    dev = resolve_device(device)
    L = pm.mat.shape[1]
    s = torch.as_tensor(seq).to(dev, torch.int64)
    n = s.shape[0] - L + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    # row 4 scores 0: the code of every base that is not A, C, G or T
    w = torch.zeros((5, L), dtype=torch.float64, device=dev)
    w[:4] = torch.as_tensor(pm.mat, dtype=torch.float32).to(torch.float64)
    acgt = (s >= 0) & (s < 4)
    code = torch.where(acgt, s, 4) * L
    flat = w.reshape(-1)
    scores = flat[code[:n]].clone()
    for j in range(1, L):
        scores += flat[code[j:j + n] + j]
    bad = torch.zeros(s.shape[0] + 1, dtype=torch.int32, device=dev)
    torch.cumsum(s >= 4, 0, dtype=torch.int32, out=bad[1:])
    return torch.where(bad[L:] - bad[:n] > 0, float("-inf"),
                       scores.to(torch.float32))
