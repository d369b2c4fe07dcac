"""Feed-forward blocks: SwiGLU (llama family) and the GELU MLP (whisper).
The products stay ``torch.einsum``, as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.base import ArchConfig, ParamDef


def ffn_defs(cfg: ArchConfig, d_ff: int = 0, stacked_layers: int = 0) -> dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    L = (stacked_layers,) if stacked_layers else ()
    ax = ("layers",) if stacked_layers else ()
    dt = cfg.param_dtype
    if cfg.act == "gelu":
        return {
            "up": ParamDef(L + (D, Fd), ax + ("embed", "mlp"), "normal", dt),
            "up_b": ParamDef(L + (Fd,), ax + ("mlp",), "zeros", dt),
            "down": ParamDef(L + (Fd, D), ax + ("mlp", "embed"), "normal", dt),
            "down_b": ParamDef(L + (D,), ax + ("embed",), "zeros", dt),
        }
    return {
        "gate": ParamDef(L + (D, Fd), ax + ("embed", "mlp"), "normal", dt),
        "up": ParamDef(L + (D, Fd), ax + ("embed", "mlp"), "normal", dt),
        "down": ParamDef(L + (Fd, D), ax + ("mlp", "embed"), "normal", dt),
    }


def ffn_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["up"]) + p["up_b"],
                   approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h, p["down"]) + p["down_b"]
    g = F.silu(torch.einsum("bsd,df->bsf", x, p["gate"]))
    u = torch.einsum("bsd,df->bsf", x, p["up"])
    return torch.einsum("bsf,fd->bsd", g * u, p["down"])
