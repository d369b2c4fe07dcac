"""Adam with the reference's op order (``optim/transform.py::scale_by_adam``,
then ``scale(-lr)``, then ``apply_updates``).

Per parameter tensor, in float32:

    count = count + 1
    mu    = b1 * mu + (1 - b1) * g
    nu    = b2 * nu + (1 - b2) * g * g
    c1    = 1 - b1 ** count          (count as float32)
    c2    = 1 - b2 ** count
    p     = p + ((mu / c1) / (sqrt(nu / c2) + eps)) * (-lr)

``torch.optim.Adam`` divides by ``sqrt(nu) / sqrt(c2) + eps`` instead, which
moves ``eps`` relative to the bias correction; early updates, where ``nu`` is
tiny, then differ far beyond rounding. The CUDA learner
(``kernels/csrc/ddpg_learn.cu``) follows this order too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


class AdamHyper(NamedTuple):
    """The Python constants of one Adam transform; every one is rounded to
    float32 where it meets a float32 tensor, as in the reference."""

    lr: float
    b1: float = B1
    b2: float = B2
    eps: float = EPS


def bias_corrections(count: torch.Tensor, hyper: AdamHyper) -> tuple:
    """(c1, c2) for the already-incremented int ``count`` (any shape)."""
    cf = count.to(torch.float32)
    return 1 - hyper.b1 ** cf, 1 - hyper.b2 ** cf


def adam_step(params: list, grads: list, mu: list, nu: list,
              count: torch.Tensor, hyper: AdamHyper) -> tuple:
    """One Adam step over lists of same-shaped tensors. ``count`` holds the
    steps taken so far; it may carry leading session axes, which broadcast
    against the parameters' leading axes. Returns
    ``(params', mu', nu', count + 1)`` as new tensors."""
    count = count + 1
    c1, c2 = bias_corrections(count, hyper)
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        lead = (...,) + (None,) * (p.dim() - count.dim())
        m = hyper.b1 * m + (1 - hyper.b1) * g
        v = hyper.b2 * v + (1 - hyper.b2) * torch.square(g)
        u = (m / c1[lead]) / (torch.sqrt(v / c2[lead]) + hyper.eps)
        new_p.append(p + u * (-hyper.lr))
        new_mu.append(m)
        new_nu.append(v)
    return new_p, new_mu, new_nu, count
