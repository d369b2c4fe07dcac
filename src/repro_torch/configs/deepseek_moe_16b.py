"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf].

Approximation (the JAX package's, kept): the real model's dense first layer
is folded into the shared experts (all 28 layers are MoE+shared here)."""

import torch

from repro_torch.models.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        attention="gqa", rope_theta=1e4,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared_experts=2, capacity_factor=1.25),
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        notes="dense first layer folded into shared experts (approx)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=512,
        attention="gqa",
        # capacity_factor >= E/k so no token is ever dropped at smoke sizes:
        # capacity-based drops depend on the batch of tokens routed together,
        # so incremental decode would part from the parallel forward
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=96,
                      num_shared_experts=2, capacity_factor=3.0),
    )
