"""Kernel dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version. There are no modes and no
environment variables; the tensor's device decides, and a CUDA tensor never
falls back to the plain version."""

from __future__ import annotations

import torch

from repro_torch.core.ddpg import DDPGConfig, DDPGState
from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain
from repro_torch.kernels.episode_learn import EpisodeKernelSpec, \
    EpisodeOperands, episode_learn, episode_learn_plain


def ddpg_inner_loop(state: DDPGState, batches: tuple, *,
                    cfg: DDPGConfig) -> torch.Tensor:
    """All U DDPG updates of N sessions (``kernels.ddpg_learn``): updates
    ``state`` in place, returns the metrics ``[N, U, 3]``."""
    device = state.flat.device
    if device.type == "cuda":
        return ddpg_learn(state, batches, cfg=cfg)
    if device.type == "cpu":
        return ddpg_learn_plain(state, batches, cfg=cfg)
    raise ValueError(f"no DDPG learner for device {device}")


def episode_inner_loop(operands: EpisodeOperands, *,
                       spec: EpisodeKernelSpec):
    """N sessions' whole T-step episodes (``kernels.episode_learn``):
    updates ``operands.carry`` in place, returns the trace."""
    device = operands.carry.ddpg.flat.device
    if device.type == "cuda":
        return episode_learn(operands, spec=spec)
    if device.type == "cpu":
        return episode_learn_plain(operands, spec=spec)
    raise ValueError(f"no episode kernel for device {device}")
