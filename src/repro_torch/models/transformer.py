"""The decoder-only model stack for the dense and MoE families (GQA
attention + a SwiGLU or GELU MLP, or a mixture of experts), the hybrid
family (zamba2: Mamba2 blocks with one weight-shared attention block) and
the ``ssm`` family (rwkv6: time mix and channel mix, no attention), with
the serving entry points.

Layers are stacked along a leading ``layers`` axis, as in the JAX package
(``repro/models/transformer.py``); where JAX scans over the stack, the port
runs a Python loop over the per-layer views of the stacked tensors, taken
once per call with ``torch.unbind`` (so that autograd stacks the layers'
gradients once, instead of building one full-size gradient per layer and
summing them). Caches follow the same stacking.

Entry points:
    model_defs(cfg)                          -> ParamDef tree
    cache_spec(cfg, batch, max_seq)          -> ParamDef tree of the cache
    make_cache(cfg, batch, max_seq, device)  -> cache (zeros)
    abstract_cache(cfg, batch, max_seq)      -> cache on the ``meta`` device
    forward(cfg, params, tokens, ...)        -> (logits, aux)  [training]
    prefill(cfg, params, tokens, cache)      -> (last-token logits, cache)
    decode_step(cfg, params, tok, cache, i)  -> (logits, cache)

The cache is updated IN PLACE (the JAX version is pure: its
``dynamic_update_slice`` returns a new cache); both functions return the
dict they were given. (The ``ssm`` family's ``state`` entry is replaced
where its type changes: a prefill leaves it in the compute type, as the
JAX package does.) The other branches (MLA, enc-dec) raise naming their
ROADMAP row, and so does training the hybrid and ``ssm`` families
(``remat``, or gradients through their scan kernels on the card: ROADMAP
A11f and A11g).
"""

from __future__ import annotations

import operator
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa_apply, gqa_defs, rope_angles
from repro_torch.models.base import ArchConfig, ParamDef, apply_norm, \
    map_defs, norm_defs
from repro_torch.models.ffn import ffn_apply, ffn_defs
from repro_torch.models.moe import moe_apply, moe_defs
from repro_torch.models.rwkv import rwkv6_channel_mix, rwkv6_defs, \
    rwkv6_time_mix, rwkv_dims
from repro_torch.models.ssm import mamba2_apply, mamba2_decode, mamba2_defs, \
    ssm_dims


def _require_ported(cfg: ArchConfig) -> None:
    """Raise for every branch of the JAX stack this port does not have."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet: ROADMAP A11")
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm"):
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.attention == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  f"yet: ROADMAP A11")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig) -> dict:
    return {"tok": ParamDef((cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed_table"), "small",
                            cfg.param_dtype)}


def _decoder_layer_defs(cfg: ArchConfig, L: int) -> dict:
    """One stacked decoder layer (attention + mlp or moe)."""
    d = {"attn_norm": norm_defs(cfg),
         "attn": gqa_defs(cfg, stacked_layers=L),
         "mlp_norm": norm_defs(cfg)}
    if cfg.moe is not None:
        d["moe"] = moe_defs(cfg, stacked_layers=L)
    else:
        d["mlp"] = ffn_defs(cfg, stacked_layers=L)
    return d


def model_defs(cfg: ArchConfig) -> dict:
    _require_ported(cfg)
    L = cfg.num_layers
    defs: dict = {"embed": embed_defs(cfg)}
    if cfg.family == "hybrid":  # zamba2
        defs["layers"] = {"norm": norm_defs(cfg),
                          "mamba": mamba2_defs(cfg, stacked_layers=L)}
        defs["shared_attn"] = {"norm": norm_defs(cfg, stacked=False),
                               "attn": gqa_defs(cfg, stacked_layers=0)}
    elif cfg.family == "ssm":  # rwkv6 (the channel mix's cm_* in time_mix)
        defs["layers"] = {"tm_norm": norm_defs(cfg),
                          "time_mix": rwkv6_defs(cfg, stacked_layers=L),
                          "cm_norm": norm_defs(cfg)}
    else:
        defs["layers"] = _decoder_layer_defs(cfg, L)
    defs["final_norm"] = norm_defs(cfg, stacked=False)
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"), "small",
                                   cfg.param_dtype)
    return defs


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """ParamDef-style spec of the serving cache: k and v
    ``[L, batch, max_seq, Kv, Dh]`` in the compute dtype; for the hybrid
    family the Mamba2 blocks' float32 SSM ``state [L, batch, H, N, P]``,
    their conv tails ``conv_x [L, batch, K-1, d_inner]`` and ``conv_bc
    [L, batch, K-1, 2N]``, and the shared attention's ``attn_k`` and
    ``attn_v [L / every, batch, max_seq, Kv, Dh]``, one slot per
    application; for the ``ssm`` family the WKV ``state [L, batch, H, c,
    c]`` declared float32 (a prefill leaves it in the compute type) and the
    token-shift rows ``tm_last`` and ``cm_last [L, batch, d_model]``, whose
    size does not grow with ``max_seq``."""
    _require_ported(cfg)
    dt = cfg.compute_dtype
    L = cfg.num_layers
    kv = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    if cfg.family == "ssm":
        H, c = rwkv_dims(cfg)
        last = ParamDef((L, batch, cfg.d_model), ("layers", "batch", "embed"),
                        "zeros", dt)
        return {"state": ParamDef((L, batch, H, c, c),
                                  ("layers", "batch", "ssm_heads",
                                   "head_dim", "head_dim"), "zeros",
                                  torch.float32),
                "tm_last": last, "cm_last": last}
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_inner, H = ssm_dims(cfg)
        GN = s.n_groups * s.d_state
        n_attn = L // cfg.hybrid_attn_every
        return {
            "state": ParamDef((L, batch, H, GN // s.n_groups, s.head_dim),
                              ("layers", "batch", "ssm_heads", "state",
                               "head_dim"), "zeros", torch.float32),
            "conv_x": ParamDef((L, batch, s.d_conv - 1, d_inner),
                               ("layers", "batch", "conv", "ssm_inner"),
                               "zeros", dt),
            "conv_bc": ParamDef((L, batch, s.d_conv - 1, 2 * GN),
                                ("layers", "batch", "conv", "ssm_bc"),
                                "zeros", dt),
            "attn_k": ParamDef((n_attn,) + kv, kv_axes, "zeros", dt),
            "attn_v": ParamDef((n_attn,) + kv, kv_axes, "zeros", dt),
        }
    return {"k": ParamDef((L,) + kv, kv_axes, "zeros", dt),
            "v": ParamDef((L,) + kv, kv_axes, "zeros", dt)}


def make_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    device = resolve_device(device)
    return map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                          device=device),
                    cache_spec(cfg, batch, max_seq))


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int):
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"),
                    cache_spec(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _default_positions(batch: int, seq: int, offset=0,
                       device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    return pos.expand(batch, seq)


def _unstack(tree: dict, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree: ``torch.unbind`` of
    every tensor, once."""
    flat = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _attn_mlp_layer(cfg: ArchConfig, angles, impl, cache_index):
    """Builds ``layer_fn(x, lp, lc) -> (x, aux)`` for the dense and MoE
    families; ``lc`` (the layer's cache views) is written in place, and
    ``aux`` is the MoE layer's load-balance loss (None for an MLP layer,
    which adds nothing)."""
    def layer_fn(x, lp, lc):
        h = apply_norm(cfg, lp["attn_norm"], x)
        a, _ = gqa_apply(cfg, lp["attn"], h, angles=angles, cache=lc,
                         cache_index=cache_index, impl=impl)
        x = x + a.to(x.dtype)
        h = apply_norm(cfg, lp["mlp_norm"], x)
        if cfg.moe is not None:
            f, aux = moe_apply(cfg, lp["moe"], h)
        else:
            f, aux = ffn_apply(cfg, lp["mlp"], h), None
        return x + f.to(x.dtype), aux
    return layer_fn


#: the JAX package's ``remat`` policies that the port runs
REMAT = ("none", "full")


def _stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *, angles,
           caches=None, cache_index=None, impl="auto", remat="none"):
    """Runs the layer stack, layer by layer. Returns (hidden, caches, aux),
    aux the float32 sum of the layers' auxiliary losses in layer order.

    ``remat="full"`` wraps each layer in non-reentrant activation
    checkpointing (the counterpart of ``jax.checkpoint``): a layer keeps only
    its input, and its forward runs again during the backward pass.
    ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) is not ported."""
    if remat == "dots":
        raise NotImplementedError("remat='dots' is not ported yet: ROADMAP "
                                  "A11 (training options)")
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; choose from {REMAT} "
                         f"or 'dots'")
    if cfg.family == "ssm":
        if remat != "none":
            raise NotImplementedError("training the ssm family (remat) is "
                                      "not ported yet: ROADMAP A11g")
        return _rwkv_stack(cfg, params, x, caches=caches)
    if cfg.family == "hybrid":
        if remat != "none":
            raise NotImplementedError("training the hybrid family (remat) "
                                      "is not ported yet: ROADMAP A11f")
        return _hybrid_stack(cfg, params, x, angles=angles, caches=caches,
                             cache_index=cache_index, impl=impl)
    layer_fn = _attn_mlp_layer(cfg, angles, impl, cache_index)
    layers = _unstack(params["layers"], cfg.num_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for index, lp in enumerate(layers):
        lc = None if caches is None else \
            {"k": caches["k"][index], "v": caches["v"][index]}
        if remat == "full" and lc is None:
            x, a = checkpoint(layer_fn, x, lp, None, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = layer_fn(x, lp, lc)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def _hybrid_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *, angles,
                  caches, cache_index, impl):
    """zamba2: ``L / every`` groups of ``every`` Mamba2 blocks, each group
    followed by ONE application of the weight-shared attention block
    (``shared_attn``). Block ``g every + i`` reads and writes layer index
    ``g every + i`` of the Mamba2 caches, application g attention slot g,
    in place. A decode step (``cache_index`` given) runs the recurrent
    Mamba2 step; otherwise the chunked scan. Returns (hidden, caches, aux
    = 0)."""
    every, L = cfg.hybrid_attn_every, cfg.num_layers
    if every <= 0 or L % every:
        raise ValueError(f"{L} layers do not split into groups of {every}")
    layers = _unstack(params["layers"], L)
    shared = params["shared_attn"]
    for g in range(L // every):
        for index in range(g * every, (g + 1) * every):
            lp = layers[index]
            lc = None if caches is None else \
                {k: caches[k][index] for k in ("state", "conv_x", "conv_bc")}
            h = apply_norm(cfg, lp["norm"], x)
            if cache_index is None:
                o, _ = mamba2_apply(cfg, lp["mamba"], h, cache=lc)
            else:
                o, _ = mamba2_decode(cfg, lp["mamba"], h, lc)
            x = x + o.to(x.dtype)
        h = apply_norm(cfg, shared["norm"], x)
        ac = None if caches is None else \
            {"k": caches["attn_k"][g], "v": caches["attn_v"][g]}
        a, _ = gqa_apply(cfg, shared["attn"], h, angles=angles, cache=ac,
                         cache_index=cache_index, impl=impl)
        x = x + a.to(x.dtype)
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def _rwkv_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                caches):
    """rwkv6: per layer the time mix, then the channel mix (whose ``cm_*``
    parameters live in ``time_mix``), each after its norm and added to the
    residual. With ``caches`` a one-token x is a decode step and a longer
    one a prefill: layer i reads and writes index i of ``state``,
    ``tm_last`` and ``cm_last``, in place; where the new states' type
    differs from the cache's (a bf16 prefill of the float32 zeros), the
    ``state`` entry is replaced by one of the new type. Returns (hidden,
    caches, aux = 0)."""
    layers = _unstack(params["layers"], cfg.num_layers)
    states = None
    for index, lp in enumerate(layers):
        tm_cache = cm_cache = None
        if caches is not None:
            tm_cache = {"state": caches["state"][index],
                        "last_x": caches["tm_last"][index]}
            cm_cache = {"last_x": caches["cm_last"][index]}
        h = apply_norm(cfg, lp["tm_norm"], x)
        a, new_tm = rwkv6_time_mix(cfg, lp["time_mix"], h, cache=tm_cache)
        x = x + a.to(x.dtype)
        h = apply_norm(cfg, lp["cm_norm"], x)
        f, new_cm = rwkv6_channel_mix(cfg, lp["time_mix"], h, cache=cm_cache)
        x = x + f.to(x.dtype)
        if caches is None:
            continue
        if states is None:
            old = caches["state"]
            states = old if new_tm["state"].dtype == old.dtype else \
                torch.empty(old.shape, dtype=new_tm["state"].dtype,
                            device=old.device)
        states[index] = new_tm["state"]
        caches["tm_last"][index] = new_tm["last_x"]
        caches["cm_last"][index] = new_cm["last_x"]
    if caches is not None:
        caches["state"] = states
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def _logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)


def _angles(cfg: ArchConfig, positions) -> Optional[torch.Tensor]:
    """The rotary angles, or None for a family without attention."""
    if cfg.family == "ssm" or cfg.attention == "none":
        return None
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.mrope_sections)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "auto", remat: str = "none") -> tuple:
    """Full-sequence forward (training / evaluation): ``(logits [B, S, V],
    aux)``, aux the float32 0-d auxiliary loss: the sum over the layers of
    the MoE load-balance loss (0 for the dense family), as in the JAX
    package. ``input_embeds`` ``[B, S, d_model]`` replaces the
    token embedding when given; ``positions`` ``[B, S]`` default to
    ``0..S-1``. (The JAX version's ``unroll`` tunes its layer scan; a
    Python layer loop has none.)"""
    _require_ported(cfg)
    B, S = tokens.shape[:2]
    if input_embeds is not None:
        x = input_embeds.to(cfg.compute_dtype)
    else:
        x = params["embed"]["tok"][tokens].to(cfg.compute_dtype)
    if positions is None:
        positions = _default_positions(B, S, device=tokens.device)
    x, _, aux = _stack(cfg, params, x, angles=_angles(cfg, positions),
                       impl=attn_impl, remat=remat)
    return _logits(cfg, params, x), aux


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache, *,
            attn_impl: str = "auto") -> tuple:
    """Process the prompt ``tokens [B, S]`` (positions 0..S-1) and write
    its keys and values into ``cache`` (in place); returns ``(logits
    [B, 1, V] of the last token, cache)``."""
    _require_ported(cfg)
    B, S = tokens.shape[:2]
    x = params["embed"]["tok"][tokens].to(cfg.compute_dtype)
    positions = _default_positions(B, S, device=tokens.device)
    x, cache, _ = _stack(cfg, params, x, angles=_angles(cfg, positions),
                         caches=cache, impl=attn_impl)
    return _logits(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: ArchConfig, params: dict, tokens: torch.Tensor, cache,
                cache_index) -> tuple:
    """One decode step: ``tokens [B, 1]`` at position ``cache_index`` (the
    current length, an int), attending over the cache's first
    ``cache_index + 1`` slots; writes its key and value into slot
    ``cache_index`` (in place). Returns ``(logits [B, 1, V], cache)``."""
    _require_ported(cfg)
    cache_index = operator.index(cache_index)
    x = params["embed"]["tok"][tokens].to(cfg.compute_dtype)
    positions = _default_positions(tokens.shape[0], 1, offset=cache_index,
                                   device=tokens.device)
    x, cache, _ = _stack(cfg, params, x, angles=_angles(cfg, positions),
                         caches=cache, cache_index=cache_index, impl="ref")
    return _logits(cfg, params, x), cache
