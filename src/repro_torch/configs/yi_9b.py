"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA [arXiv:2403.04652]."""

import torch

from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-9b", family="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000,
        attention="gqa", rope_theta=1e4,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="yi-9b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512,
        attention="gqa",
    )
