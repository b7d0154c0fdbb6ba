"""Population genetics on the device: the counterparts of
``gonomics_tpu/popgen.py``'s ``afs_sample_density_grid`` (:375) and
``wright_fisher_sim`` (:405). The rest of the JAX module is host code
that the port does not use yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def afs_sample_density_grid(n, k, alpha, grid_points: int = 2049,
                            device=None) -> torch.Tensor:
    """The log F function (the selection-weighted allele-frequency
    integral of AfsSampleDensity) of each (n, k, alpha) on ``device``
    (None: the card): a composite Simpson sum over ``grid_points`` points
    of p in [1e-9, 1 - 1e-9], in log space, as a float32 tensor.

    float32 whatever the input, as the JAX function, whose float64 branch
    (popgen.py:383-384) is overwritten on :385. So 1 - 1e-9 rounds to 1.0,
    the last point's log1p(-p) is -inf, and where k = n - 1 its term is
    0 * -inf: the result is NaN there, as the JAX's is."""
    dev = resolve_device(device)
    f32 = torch.float32
    n, k, alpha = (torch.as_tensor(np.asarray(x)).to(dev, f32)
                   for x in (n, k, alpha))
    p = torch.linspace(1e-9, 1 - 1e-9, grid_points, dtype=f32, device=dev)
    log_binom = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                 - torch.lgamma(n - k + 1))
    lp = torch.log(p)[None, :]
    l1p = torch.log1p(-p)[None, :]
    expr = (k[:, None] - 1) * lp + (n[:, None] - k[:, None] - 1) * l1p
    sel = torch.log((1 - torch.exp(-alpha[:, None] * (1 - p[None, :]))) * 2
                    / (1 - torch.exp(-alpha[:, None])))
    log_f = log_binom[:, None] + expr + sel
    w = torch.ones(grid_points, dtype=f32, device=dev)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    h = (p[-1] - p[0]) / (grid_points - 1)
    m = torch.amax(log_f, dim=1, keepdim=True)
    integral = torch.sum(w[None, :] * torch.exp(log_f - m), dim=1) * h / 3
    return m[:, 0] + torch.log(integral)


def wright_fisher_sim(pop_size: int, generations: int, s: float = 0.0,
                      init_freq: float = 0.5, seed: int = 0,
                      device=None) -> torch.Tensor:
    """A forward Wright-Fisher allele-frequency trajectory, (generations,)
    float32 on ``device`` (None: the card): each generation draws
    Binomial(pop_size, p) with p the selection-weighted frequency
    freq (1 + s) / (freq (1 + s) + 1 - freq), and the next frequency is
    draws / pop_size. The draws come from a ``torch.Generator`` on the
    device seeded with ``seed``, so a seed gives the same trajectory on
    one device; they cannot replay the JAX function's ``jax.random``
    stream, so the two agree in distribution, not draw for draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    count = torch.full((1,), float(pop_size), dtype=torch.float32,
                       device=dev)
    freq = torch.full((1,), init_freq, dtype=torch.float32, device=dev)
    traj = torch.empty(generations, dtype=torch.float32, device=dev)
    for t in range(generations):
        w = freq * (1 + s)
        p = w / (w + (1 - freq))
        freq = torch.binomial(count, p, generator=gen) / pop_size
        traj[t] = freq[0]
    return traj
