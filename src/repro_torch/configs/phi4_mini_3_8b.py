"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905]. Tied embeddings."""

import torch

from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=200064,
        attention="gqa", rope_theta=1e4, tie_embeddings=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        attention="gqa", tie_embeddings=True,
    )
