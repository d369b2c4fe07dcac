"""Device resolution for the port's entry points.

``Tuner``, ``MagpieAgent`` and ``ddpg_init`` run on the card unless the
caller asks for the CPU. With no device given and no card present they
raise: a run that silently fell back to the CPU would report CPU numbers
under a GPU's name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
