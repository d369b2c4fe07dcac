"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5-arch (QKV bias) [hf:Qwen/CodeQwen1.5-7B]."""

import torch

from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=13440, vocab_size=92416,
        attention="gqa", qkv_bias=True, rope_theta=1e6,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        attention="gqa", qkv_bias=True,
    )
