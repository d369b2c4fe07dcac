"""The LM model stack of the port (dense, MoE, hybrid and ``ssm`` (RWKV6)
families): configs' dataclasses, parameter definitions, the training forward and the serving
entry points."""

from repro_torch.models.base import (
    ArchConfig, MLAConfig, MoEConfig, ParamDef, SSMConfig,
    abstract_params, init_params, param_bytes, param_count,
)
from repro_torch.models.transformer import (
    abstract_cache, decode_step, forward, make_cache, model_defs, prefill,
)

__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig", "ParamDef", "SSMConfig",
    "abstract_params", "init_params", "param_bytes", "param_count",
    "abstract_cache", "decode_step", "forward", "make_cache", "model_defs",
    "prefill",
]
