"""Model substrate: architecture config, parameter definitions and the shared
numerics (norms, initializers), in PyTorch.

A model is (a) an ``ArchConfig``, (b) a tree of ``ParamDef`` leaves (nested
dicts) describing every parameter's shape, logical axes, initializer and
dtype, and (c) forward functions over the materialized tree, a nested dict
of tensors with the same keys. The tree drives:

    init_params(defs, generator, device) -> real tensors
    abstract_params(defs)                -> tensors on the ``meta`` device
                                            (shapes only, nothing allocated)
    param_count(defs), param_bytes(defs)

The layouts are the JAX package's (``repro/models/base.py``): layer stacks
carry a leading ``layers`` axis, projections are ``[in, ...out]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0      # deepseek-moe: always-on experts
    dense_residual: bool = False     # arctic: parallel dense MLP branch
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64               # mamba2 SSD head size
    chunk: int = 256                 # SSD chunk length
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention
    attention: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False           # qwen-style QKV bias
    rope_theta: float = 1e4
    mrope_sections: tuple = ()       # qwen2-vl M-RoPE (t, h, w) half-dim split
    # submodule configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* attention block applied every k SSM blocks
    hybrid_attn_every: int = 0
    # rwkv6
    rwkv_head_size: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # e.g. 1500 mel frames
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (SSM/linear-attention state)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameter count (from the ParamDef tree, exact)."""
        from repro_torch.models.transformer import model_defs  # (cycle)
        return param_count(model_defs(self))


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                      # logical axis name per dim (same length)
    init: str = "normal"             # normal | zeros | ones | small
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def iter_defs(defs, prefix=()):
    """``(path, ParamDef)`` of every leaf, keys in sorted order (the order
    in which JAX flattens a dict)."""
    if isinstance(defs, ParamDef):
        yield prefix, defs
        return
    for k in sorted(defs):
        yield from iter_defs(defs[k], prefix + (k,))


def map_defs(fn, defs):
    """The tree of ``fn(ParamDef)`` with the same keys."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def abstract_params(defs):
    """Tensors on the ``meta`` device: shapes and dtypes, no allocation."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def init_params(defs, generator: torch.Generator, device=None):
    """Materialize real parameters with the JAX package's scale rule
    (``repro/models/base.py::init_params``): zeros, ones, or a standard
    normal times 0.02 ("small") or ``1 / sqrt(fan_in)`` with
    ``fan_in = shape[-2]`` (the last dim for a vector), drawn in float32
    and cast to the leaf's dtype. The leaves draw from ``generator`` in
    JAX's flattening order, on the generator's device, and land on
    ``device`` (default: the generator's). The draws are not JAX's; carry
    the reference's parameters across with ``convert.lm_params_from_jax``
    where they must match."""
    device = torch.device(device) if device is not None else generator.device

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(1, d.shape[-1])
        scale = 0.02 if d.init == "small" else 1.0 / math.sqrt(fan_in)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device).mul_(scale)
        return x.to(device=device, dtype=d.dtype)

    out: dict = {}
    for path, d in iter_defs(defs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make(d)
    return out


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in iter_defs(defs))


def param_bytes(defs) -> int:
    return sum(int(np.prod(d.shape)) * d.dtype.itemsize
               for _, d in iter_defs(defs))


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Statistics in float32, the normalized row cast back to x's type, then
    times the scale in x's type."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def norm_defs(cfg: ArchConfig, stacked: bool = True) -> dict:
    L = (cfg.num_layers,) if stacked else ()
    ax = ("layers",) if stacked else ()
    d = {"scale": ParamDef(L + (cfg.d_model,), ax + ("embed",), "ones",
                           cfg.param_dtype)}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef(L + (cfg.d_model,), ax + ("embed",), "zeros",
                             cfg.param_dtype)
    return d
