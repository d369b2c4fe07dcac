"""Mamba2 (SSD, state-space duality) block: chunked-parallel for prefill and
one recurrent step on the O(1) state for decode, in PyTorch.

The counterpart of the JAX package's ``repro/models/ssm.py``, op for op.
Shapes: x ``[B, S, D]``; H heads of head dim P (``d_inner = H P``); state
dim N; one group (``n_groups = 1``), so B and C are ``[B, S, N]`` and shared
by the heads. The prefill's scan is ``kernels.ops.ssd``: the CUDA kernel on
the card, its plain version on the CPU. The JAX package's off-TPU fallback
``ssd_chunked`` has no counterpart here: the port's CPU path is the kernel's
plain version, and its state is float32 in prefill and decode, as on a TPU.

The cache ``{"state" [B, H, N, P] float32, "conv_x" [B, K-1, d_inner],
"conv_bc" [B, K-1, 2N]}`` is written IN PLACE (the JAX functions are pure
and return a new one), and the same dict is returned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.base import ArchConfig, ParamDef, rmsnorm


def ssm_dims(cfg: ArchConfig) -> tuple:
    """``(d_inner, heads)``."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def mamba2_defs(cfg: ArchConfig, stacked_layers: int = 0) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H = ssm_dims(cfg)
    GN = s.n_groups * s.d_state
    L = (stacked_layers,) if stacked_layers else ()
    ax = ("layers",) if stacked_layers else ()
    dt = cfg.param_dtype
    return {
        "wz": ParamDef(L + (D, d_inner), ax + ("embed", "ssm_inner"),
                       "normal", dt),
        "wx": ParamDef(L + (D, d_inner), ax + ("embed", "ssm_inner"),
                       "normal", dt),
        "wbc": ParamDef(L + (D, 2 * GN), ax + ("embed", "ssm_bc"), "normal",
                        dt),
        "wdt": ParamDef(L + (D, H), ax + ("embed", "ssm_heads"), "normal",
                        dt),
        "conv_x_w": ParamDef(L + (s.d_conv, d_inner),
                             ax + ("conv", "ssm_inner"), "small", dt),
        "conv_x_b": ParamDef(L + (d_inner,), ax + ("ssm_inner",), "zeros",
                             dt),
        "conv_bc_w": ParamDef(L + (s.d_conv, 2 * GN), ax + ("conv", "ssm_bc"),
                              "small", dt),
        "conv_bc_b": ParamDef(L + (2 * GN,), ax + ("ssm_bc",), "zeros", dt),
        "A_log": ParamDef(L + (H,), ax + ("ssm_heads",), "zeros", dt),
        "D_skip": ParamDef(L + (H,), ax + ("ssm_heads",), "ones", dt),
        "dt_bias": ParamDef(L + (H,), ax + ("ssm_heads",), "zeros", dt),
        "norm": ParamDef(L + (d_inner,), ax + ("ssm_inner",), "ones", dt),
        "wo": ParamDef(L + (d_inner, D), ax + ("ssm_inner", "embed"),
                       "normal", dt),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv over the sequence: u ``[B, S, C]``, w ``[K, C]``,
    the K shifted products summed in order, then b. ``state`` is the last
    K-1 inputs of the previous call (decode; zeros when None). Returns
    ``(out, new_state)``."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    up = torch.cat([state, u], dim=1)                    # [B, S+K-1, C]
    out = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(K)) + b
    new_state = up[:, -(K - 1):, :] if K > 1 else state
    return out, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``. XLA's ``log1p``
    and ``exp`` are its own, so about one element in ten differs from the
    reference by one ulp."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted type, as ``jnp.einsum``."""
    dt = operands[0].dtype
    for t in operands[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(spec, *(t.to(dt) for t in operands))


def _write(cache: Optional[dict], **new) -> Optional[dict]:
    if cache is None:
        return None
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def mamba2_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                 cache: Optional[dict] = None) -> tuple:
    """Prefill (and full-sequence) path: x ``[B, S, D]`` -> ``(out [B, S, D],
    cache)``. With a ``cache`` (``{"state", "conv_x", "conv_bc"}`` views of
    one layer), the final SSM state and the conv tails are written into it
    for the decode steps that follow. The scan's chunk is
    ``min(cfg.ssm.chunk, S)``; S must be a multiple of it."""
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    B, S, _ = x.shape
    z = torch.einsum("bsd,di->bsi", x, p["wz"])
    xs = torch.einsum("bsd,di->bsi", x, p["wx"])
    bc = torch.einsum("bsd,dg->bsg", x, p["wbc"])
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"])

    xs, conv_x_state = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc, conv_bc_state = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    xs, bc = F.silu(xs), F.silu(bc)

    GN = s.n_groups * s.d_state
    Bm, Cm = bc[..., :GN], bc[..., GN:]
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    xh = xs.reshape(B, S, H, s.head_dim)
    y, state = ops.ssd(xh, dt, A, Bm, Cm, min(s.chunk, S))
    y = y + xh * p["D_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["wo"])
    return out, _write(cache, state=state, conv_x=conv_x_state,
                       conv_bc=conv_bc_state)


def mamba2_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
                  cache: dict) -> tuple:
    """One recurrent step: x ``[B, 1, D]``, ``cache`` the layer's
    ``{"state" [B, H, N, P] float32, "conv_x", "conv_bc"}`` (updated in
    place). The state update ``S dA + B dt x`` runs in float32 (the state's
    type), its outer product ``einsum("bn,bh,bhp->bhnp")`` in x's type and
    XLA's order, ``(B dt) x`` (bitwise in bf16 on the CPU); y stays float32
    into the norm, as on a TPU."""
    s = cfg.ssm
    d_inner, H = ssm_dims(cfg)
    B = x.shape[0]
    z = torch.einsum("bsd,di->bsi", x, p["wz"])
    xs = torch.einsum("bsd,di->bsi", x, p["wx"])
    bc = torch.einsum("bsd,dg->bsg", x, p["wbc"])
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"])

    xs, conv_x_state = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"],
                                    cache["conv_x"])
    bc, conv_bc_state = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                     cache["conv_bc"])
    xs, bc = F.silu(xs), F.silu(bc)
    GN = s.n_groups * s.d_state
    Bm, Cm = bc[:, 0, :GN], bc[:, 0, GN:]
    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())

    xh = xs[:, 0].reshape(B, H, s.head_dim)
    S_prev = cache["state"]                               # [B, H, N, P]
    dA = torch.exp(dt * A)                                # [B, H]
    # einsum("bn,bh,bhp->bhnp") in x's type, as (B dt) x: XLA's order
    upd = (Bm[:, None, :, None] * dt.to(x.dtype)[:, :, None, None]) \
        * xh[:, :, None, :]
    S_new = S_prev * dA[:, :, None, None].to(S_prev.dtype) + upd
    y = _einsum("bn,bhnp->bhp", Cm, S_new)
    y = y + xh * p["D_skip"][None, :, None].to(y.dtype)
    y = y.reshape(B, 1, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = _einsum("bsi,id->bsd", y, p["wo"])
    return out, _write(cache, state=S_new, conv_x=conv_x_state,
                       conv_bc=conv_bc_state)
