"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242].

Approximation (the JAX package's, kept): 81 Mamba2 blocks with ONE
weight-shared GQA attention block applied after every 9th block (9
applications). The real model interleaves two shared blocks with
LoRA-modulated reuse; the shared-weights-many-applications structure is
preserved. d_ff is unused (no MLP in the mamba blocks; the shared block is
attention-only here)."""

import torch

from repro_torch.models.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        attention="gqa", rope_theta=1e4,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        hybrid_attn_every=9,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        notes="shared attention applied once per 9 mamba blocks (approx)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        attention="gqa",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        hybrid_attn_every=2,
    )
