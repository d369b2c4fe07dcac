"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892]. Head size 64 -> 40 heads.
O(1) recurrent state for decode; the chunked WKV scan for the forward and
prefill."""

import torch

from repro_torch.models.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=8960, vocab_size=65536,
        attention="none", rwkv_head_size=64,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        attention="none", rwkv_head_size=16,
    )
