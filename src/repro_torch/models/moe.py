"""Mixture-of-Experts with sort-based capacity dispatch, in PyTorch
(``repro/models/moe.py``).

Covers both MoE architectures of the JAX package:
  * deepseek-moe-16b: 64 fine-grained routed experts (top-6) + 2 shared
    experts that process every token;
  * arctic-480b: 128 routed experts (top-2) + a parallel dense residual MLP
    summed with the MoE output.

Dispatch sorts the token-expert pairs by expert (a stable argsort) and
crops each expert to its capacity C, so memory is O(T k + E C D). The
experts run as one grouped SwiGLU over ``[E, C, D]``
(``kernels.ops.grouped_swiglu``: the ``gmm`` kernel where C, D and F are
multiples of 128). The reference's ``constrain_batch`` and
``constrain_experts`` are sharding hints that do nothing on one device, and
are left out.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.base import ArchConfig, ParamDef
from repro_torch.models.ffn import ffn_apply, ffn_defs


def moe_defs(cfg: ArchConfig, stacked_layers: int = 0) -> dict:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    L = (stacked_layers,) if stacked_layers else ()
    ax = ("layers",) if stacked_layers else ()
    dt = cfg.param_dtype
    d = {
        "router": ParamDef(L + (D, E), ax + ("embed", "experts"), "small", dt),
        "experts": {
            "gate": ParamDef(L + (E, D, Fe),
                             ax + ("experts", "embed", "expert_mlp"), "normal",
                             dt),
            "up": ParamDef(L + (E, D, Fe),
                           ax + ("experts", "embed", "expert_mlp"), "normal",
                           dt),
            "down": ParamDef(L + (E, Fe, D),
                             ax + ("experts", "expert_mlp", "embed"), "normal",
                             dt),
        },
    }
    if m.num_shared_experts:
        d["shared"] = ffn_defs(cfg, d_ff=m.num_shared_experts * Fe,
                               stacked_layers=stacked_layers)
    if m.dense_residual:
        d["dense"] = ffn_defs(cfg, d_ff=cfg.d_ff,
                              stacked_layers=stacked_layers)
    return d


def expert_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over ``[E, C, D]`` (the ``gmm`` kernel's caller)."""
    from repro_torch.kernels import ops  # late import: kernels never import models
    return ops.grouped_swiglu(x, p["gate"], p["up"], p["down"])


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: ``ceil(T k / E *
    capacity_factor)`` rounded up to a multiple of 8, at least 8 and at most
    T, as the reference computes it."""
    m = cfg.moe
    C = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return min(tokens, max(8, -(-C // 8) * 8))


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor) -> tuple:
    """``(out [B, S, D], aux)``: the routed experts' combination plus the
    shared and dense branches, and the Switch-style load-balance loss
    ``E * sum_e f_e P_e`` (float32 0-d), in the reference's op order:

    - router logits and softmax in ``router_dtype``; the top-k with ties to
      the lower expert index (``jax.lax.top_k``'s rule: a stable descending
      sort), renormalized;
    - dispatch by a stable argsort of the flat expert ids; each pair's rank
      in its expert from ``bincount``; pairs ranked C or later go to a drop
      slot that is cut away;
    - combine: each token's contributions, weighted by its probability in
      the activation type, are added one by one into a zero of the
      activation type in ascending expert id, as XLA adds the reference's
      ``.at[st].add`` updates in their sorted order (no atomics, no float32
      sum)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    xf = x.reshape(T, D)

    logits = torch.einsum("td,de->te", xf.to(m.router_dtype),
                          p["router"].to(m.router_dtype))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                 # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- sort-based dispatch with per-expert capacity -------------------
    C = capacity(cfg, T)
    flat_e = top_e.reshape(-1)                                # [T*k]
    flat_p = top_p.reshape(-1).to(x.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, sp = flat_e[order], flat_p[order]
    st = torch.div(order, k, rounding_mode="floor")           # token ids
    counts = torch.bincount(flat_e, minlength=E)              # tokens/expert
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[se]   # rank in expert
    keep = pos < C
    slot_c = torch.where(keep, pos, torch.full_like(pos, C))  # C = drop slot

    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[se, slot_c] = xf[st]                                  # unique slots
    h = expert_ffn(p["experts"], buf[:, :C])                  # [E, C, D]

    contrib = h[se, slot_c.clamp_max(C - 1)] * (sp * keep)[:, None]
    # each token's k contributions in ascending expert id: the sorted order
    # visits a token's pairs so, and its rank among them is the count of
    # its experts below each one
    rank = (top_e[:, None, :] < top_e[:, :, None]).sum(-1).reshape(-1)
    per_token = torch.empty((T * k, D), dtype=contrib.dtype,
                            device=x.device)
    per_token[st * k + rank[order]] = contrib
    per_token = per_token.reshape(T, k, D)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + per_token[:, j]
    out = out.reshape(B, S, D)

    # ---- always-on branches ---------------------------------------------
    if m.num_shared_experts:
        out = out + ffn_apply(cfg, p["shared"], x)
    if m.dense_residual:
        out = out + ffn_apply(cfg, p["dense"], x)

    # ---- load-balance aux (Switch-style): E * sum_e f_e * P_e ------------
    f = counts.float() / max(1, T * k)
    pe = probs.float().mean(dim=0)
    aux = E * (f * pe).sum()
    return out, aux
