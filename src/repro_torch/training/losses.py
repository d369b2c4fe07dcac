"""Loss functions (``repro/training/losses.py``): float32 logsumexp whatever
the logits' type."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token cross entropy. logits ``[B, S, V]`` (any float type),
    labels ``[B, S]`` integer.

    The JAX version contracts the logits with a one-hot ``[B, S, V]`` tensor
    so that a vocabulary sharded across devices stays local. The contraction
    has one non-zero term per row, so a gather of the gold logit gives the
    same sum exactly, without 3.3 GB of one-hot at phi4-mini's vocabulary
    and batch. ``z_loss``: weight of the mean squared logsumexp (the
    PaLM-style logit-norm regularizer)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
