"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer sums a dense d_ff=4864 MLP branch with a
128-expert top-2 MoE (expert d_ff 4864). float32 parameters; the JAX
package trains it with Adafactor, which the port does not have yet
(``optim/adafactor.py`` raises). 480 B parameters do not fit one card: the
port runs it at the smoke size."""

import torch

from repro_torch.models.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000,
        attention="gqa", rope_theta=1e6,
        moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True, capacity_factor=1.25),
        param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        notes="Adafactor optimizer (AdamW state does not fit)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512,
        attention="gqa",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                      dense_residual=True, capacity_factor=1.5),
    )
