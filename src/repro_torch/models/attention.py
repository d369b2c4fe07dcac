"""Attention: RoPE, grouped-query attention (GQA) with its serving cache, and
the dispatch between the flash-attention kernel and the plain attention.

Tensor conventions, as in the JAX package (``repro/models/attention.py``):
activations ``[B, S, D_model]``; per head ``[B, S, H, Dh]``; caches
``[B, S_max, Kv, Dh]``. MLA attention and M-RoPE are not ported yet
(ROADMAP A11).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.base import ArchConfig, ParamDef


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: tuple = ()) -> torch.Tensor:
    """Rotation angles ``[B, S, head_dim // 2]`` of integer ``positions``
    ``[B, S]``."""
    if mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                                  "ROADMAP A11")
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                 device=positions.device), exponent)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: ``[B, S, H, D]``; angles: ``[B, S, D // 2]``;
    cos and sin in x's type."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# Scaled dot-product attention cores
# ---------------------------------------------------------------------------

def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's type first, as JAX
    multiplies by a Python float."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _expand_kv(q, k, v):
    """Broadcast GQA k/v up to the full head count."""
    H, Kv = q.shape[2], k.shape[2]
    if H == Kv:
        return k, v
    g = H // Kv
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, q_offset: int = 0,
             kv_len: Optional[int] = None,
             scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention (materializes the scores; GQA k/v head-expanded):
    scores in q's type then float32, masked with float32's lowest value,
    softmax in float32 cast to q's type before ``p v``.

    ``q_offset``: absolute position of q[0]; ``kv_len``: valid prefix length
    of k/v (padded caches), None for all."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k, v = _expand_kv(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bshd->bhqs", _scaled(q, scale), k).float()
    kv_pos = torch.arange(Sk, device=q.device)
    neg = torch.finfo(torch.float32).min
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        scores = scores.masked_fill(kv_pos[None, :] > q_pos[:, None], neg)
    if kv_len is not None:
        scores = scores.masked_fill(kv_pos >= kv_len, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def sdpa_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, *, kv_len: int,
                scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over the full (padded) KV cache: one
    masked einsum-softmax against the compact ``[B, S_max, Kv, Dh]`` cache
    (the JAX package computes it outside any Pallas kernel too)."""
    B, Sq, H, D = q.shape
    assert Sq == 1
    Sk, Kv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = _scaled(q, scale).reshape(B, Kv, H // Kv, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    kv_pos = torch.arange(Sk, device=q.device)
    s = s.masked_fill(kv_pos >= kv_len, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", p, v_cache).reshape(B, 1, H, D)


def sdpa(q, k, v, *, causal, q_offset=0, kv_len=None, impl: str = "auto",
         scale=None):
    """Dispatch, with the JAX package's condition for its flash kernel: with
    ``impl="auto"``, no custom scale, offset or valid length, both sequence
    lengths multiples of 128 and a head dim of at least 8, the flash
    attention of ``kernels.ops.attention`` (the tensors' device decides
    between the kernel and its plain version); everything else, and
    ``impl="ref"``, goes to ``sdpa_ref``. The JAX package's streaming
    ``"chunked"`` path is not ported (its shapes are the flash path's)."""
    if impl not in ("auto", "ref"):
        raise NotImplementedError(f"attention impl {impl!r} is not ported; "
                                  f"use 'auto' or 'ref'")
    Sq, Sk = q.shape[1], k.shape[1]
    if (impl == "auto" and scale is None and kv_len is None and q_offset == 0
            and Sq % ops.ATTENTION_BLOCK == 0
            and Sk % ops.ATTENTION_BLOCK == 0 and q.shape[-1] >= 8):
        return ops.attention(q, k, v, causal=causal)
    return sdpa_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                    scale=scale)


# ---------------------------------------------------------------------------
# GQA block (projections + attention + cache)
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ArchConfig, stacked_layers: int = 0) -> dict:
    """Parameter defs for one (or a stack of) GQA attention block(s)."""
    D, H, Kv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    L = (stacked_layers,) if stacked_layers else ()
    ax = ("layers",) if stacked_layers else ()
    dt = cfg.param_dtype
    d = {
        "wq": ParamDef(L + (D, H, Dh), ax + ("embed", "heads", "head_dim"),
                       "normal", dt),
        "wk": ParamDef(L + (D, Kv, Dh), ax + ("embed", "kv_heads", "head_dim"),
                       "normal", dt),
        "wv": ParamDef(L + (D, Kv, Dh), ax + ("embed", "kv_heads", "head_dim"),
                       "normal", dt),
        "wo": ParamDef(L + (H, Dh, D), ax + ("heads", "head_dim", "embed"),
                       "normal", dt),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef(L + (H, Dh), ax + ("heads", "head_dim"), "zeros",
                           dt)
        d["bk"] = ParamDef(L + (Kv, Dh), ax + ("kv_heads", "head_dim"),
                           "zeros", dt)
        d["bv"] = ParamDef(L + (Kv, Dh), ax + ("kv_heads", "head_dim"),
                           "zeros", dt)
    return d


def gqa_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              angles: Optional[torch.Tensor], causal: bool = True,
              cache: Optional[dict] = None,
              cache_index: Optional[int] = None,
              impl: str = "auto") -> tuple:
    """One self-attention block. Returns ``(out, cache)``.

    Modes:
      train/eval:  cache=None                       -> (out, None)
      prefill:     cache={"k","v"} [B,S_max,Kv,Dh]  -> writes [0:S)
      decode:      cache + cache_index (int)        -> writes slot cache_index

    The cache is written IN PLACE (the JAX version is pure and returns an
    updated copy), and the same dict is returned. Cross-attention (the JAX
    package's ``kv_source``, enc-dec only) is not ported (ROADMAP A11)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)

    if cache is not None and cache_index is None:
        cache["k"][:, :k.shape[1]] = k
        cache["v"][:, :v.shape[1]] = v
        out = sdpa(q, k, v, causal=causal, impl=impl)
    elif cache is not None:
        cache["k"][:, cache_index:cache_index + 1] = k
        cache["v"][:, cache_index:cache_index + 1] = v
        out = sdpa_decode(q, cache["k"], cache["v"], kv_len=cache_index + 1)
    else:
        out = sdpa(q, k, v, causal=causal, impl=impl)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
