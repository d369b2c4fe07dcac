"""RWKV6 ("Finch") block: the attention-free time mix with data-dependent,
per-channel decay, and the channel-mix FFN, in PyTorch.

The counterpart of the JAX package's ``repro/models/rwkv.py``, op for op.
Per head (head size c) the state S is ``[c, c]`` over (key, value):
``y_t = r_t^T (S_t + diag(u) k_t v_t^T)``, ``S_{t+1} = diag(w_t) S_t +
k_t v_t^T`` with ``w_t = exp(-exp(w0 + tanh(x_w A_w) B_w))``.

Three paths, routed as the JAX package routes them:
- the full-sequence forward (no cache) runs the scan through
  ``kernels.ops.wkv6``: the CUDA kernel on the card, its plain version on
  the CPU, at chunk ``min(64, S)`` (the TPU kernel's; the JAX package off
  the TPU falls back to ``wkv_chunked`` at ``min(32, S)``);
- prefill (a cache given) runs ``wkv_chunked`` from the cache's state, in
  plain PyTorch on either device, and leaves the state in the compute type
  (``wkv_chunked`` carries it in r's type), as the JAX package does on a
  TPU too;
- decode is the O(1) recurrence, in the state's type.

These functions are pure, as the reference's: they return the new cache
entries, and the layer stack (``models.transformer``) writes them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.wkv6_scan import cumsum_rounded
from repro_torch.models.base import ArchConfig, ParamDef
from repro_torch.models.ssm import _einsum

#: the decay LoRA's rank (the reference's)
DECAY_LORA = 64
#: the most elements of one group's [B, g, Q, Q, H, c] float32 decay tensor
#: in ``wkv_chunked`` (2^27: 0.5 GB); chunks are taken in groups under it
DECAY_ELEMENTS = 1 << 27


def rwkv_dims(cfg: ArchConfig) -> tuple:
    """``(heads, head size)``."""
    c = cfg.rwkv_head_size
    return cfg.d_model // c, c


def rwkv6_defs(cfg: ArchConfig, stacked_layers: int = 0) -> dict:
    """The time mix's and (``cm_*``) the channel mix's parameters."""
    D, F_ = cfg.d_model, cfg.d_ff
    H, c = rwkv_dims(cfg)
    L = (stacked_layers,) if stacked_layers else ()
    ax = ("layers",) if stacked_layers else ()
    dt = cfg.param_dtype

    def vec(init="zeros", axis="embed"):
        return ParamDef(L + (D,), ax + (axis,), init, dt)

    def mat(shape, axes, init="normal"):
        return ParamDef(L + shape, ax + axes, init, dt)

    inner = ("embed", "ssm_inner")
    return {
        # time-mix token-shift lerp coefficients
        "mu_r": vec(), "mu_k": vec(), "mu_v": vec(), "mu_g": vec(),
        "mu_w": vec(),
        # data-dependent decay LoRA
        "w0": vec(),
        "w_lora_a": mat((D, DECAY_LORA), ("embed", "q_lora"), "small"),
        "w_lora_b": mat((DECAY_LORA, D), ("q_lora", "embed"), "small"),
        # projections
        "wr": mat((D, D), inner), "wk": mat((D, D), inner),
        "wv": mat((D, D), inner), "wg": mat((D, D), inner),
        "u": mat((H, c), ("ssm_heads", "head_dim"), "zeros"),
        "ln_x": vec("ones", "ssm_inner"),
        "wo": mat((D, D), ("ssm_inner", "embed")),
        # channel mix
        "cm_mu_k": vec(), "cm_mu_r": vec(),
        "cm_wk": mat((D, F_), ("embed", "mlp")),
        "cm_wv": mat((F_, D), ("mlp", "embed")),
        "cm_wr": mat((D, D), inner),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} with a zero (or ``last``, decode) first row. x ``[B, S, D]``."""
    if x.shape[1] == 1 and last is not None:
        return last[:, None, :]
    first = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, prev, mu):
    return x + (prev - x) * mu


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None) -> tuple:
    """Chunked WKV6 with the reference's dtype casts: r, k, v ``[B, S, H,
    c]``, logw ``[B, S, H, c]`` (<= 0), u ``[H, c]`` -> ``(y [B, S, H, c],
    final state [B, H, c, c])``, both in r's type. The scores, the u bonus
    and the decays are float32; ``scores``, ``diag``, ``exp(cum_tot - cum)
    k`` and ``exp(cum_prev) r`` are rounded to r's type before their
    products with v or the state, and the state is carried from
    ``init_state`` (zeros when None) in r's type. The cumsum is
    ``cumsum_rounded``, as the kernel's.

    The reference builds the [B, z, Q, Q, H, c] float32 decay tensor of all
    z chunks at once (10.7 GB for rwkv6-3b at 4 x 4096); here the chunks are
    taken in groups whose decay tensor holds at most ``DECAY_ELEMENTS``
    elements. Each chunk's terms are computed as before, so the function is
    the same."""
    B, S, H, c = r.shape
    if S % chunk:
        raise ValueError(f"the WKV scan takes a sequence length that is a "
                         f"multiple of the chunk, got {S} and {chunk}")
    z, Q, dt = S // chunk, chunk, r.dtype
    rc, kc, vc = (t.reshape(B, z, Q, H, c) for t in (r, k, v))
    lw = logw.reshape(B, z, Q, H, c).float()
    cum = cumsum_rounded(lw, dim=2)                       # inclusive
    cum_prev = cum - lw                                   # exclusive
    cum_tot = cum[:, :, -1]                               # [B, z, H, c]
    strict = torch.ones((Q, Q), dtype=torch.bool,
                        device=r.device).tril(-1)[:, :, None, None]
    u32 = u.float()
    group = max(1, DECAY_ELEMENTS // (B * Q * Q * H * c))
    y_intra, s_local = [], []
    for g0 in range(0, z, group):
        sl = slice(g0, g0 + group)
        r32, k32 = rc[:, sl].float(), kc[:, sl].float()
        # intra-chunk: decay(t, s) = exp(cum_prev[t] - cum[s]) for s < t;
        # the diagonal is the u bonus. Every exponent is <= 0.
        dec = torch.where(strict, torch.exp(torch.clamp(
            cum_prev[:, sl, :, None] - cum[:, sl, None, :], max=0.0)), 0.0)
        scores = torch.einsum("bzthc,bztshc,bzshc->bztsh", r32, dec, k32)
        del dec
        yi = _einsum("bztsh,bzshd->bzthd", scores.to(dt), vc[:, sl])
        diag = torch.einsum("bzthc,hc,bzthc->bzth", r32, u32, k32)
        y_intra.append(yi + diag[..., None].to(dt) * vc[:, sl])
        # chunk-local end state: sum_s exp(cum_tot - cum[s]) k_s (x) v_s
        dte = torch.exp(cum_tot[:, sl, None] - cum[:, sl])
        s_local.append(_einsum("bzshc,bzshd->bzhcd",
                               dte.to(dt) * kc[:, sl], vc[:, sl]))
    y_intra, s_local = torch.cat(y_intra, 1), torch.cat(s_local, 1)

    S_prev = torch.zeros((B, H, c, c), dtype=dt, device=r.device) \
        if init_state is None else init_state.to(dt)
    starts = []
    for i in range(z):
        starts.append(S_prev)
        S_prev = torch.exp(cum_tot[:, i])[..., None].to(S_prev.dtype) \
            * S_prev + s_local[:, i]
    y_inter = _einsum("bzthc,bzhcd->bzthd",
                      torch.exp(cum_prev).to(dt) * rc,
                      torch.stack(starts, 1))
    return (y_intra + y_inter).reshape(B, S, H, c), S_prev


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in log space, float32, in
    [-exp(6), -exp(-8)]."""
    lora = _einsum("bsl,ld->bsd",
                   torch.tanh(_einsum("bsd,dl->bsl", xw, p["w_lora_a"])),
                   p["w_lora_b"])
    return -torch.exp(torch.clamp((p["w0"] + lora).float(), -8.0, 6.0))


def rwkv6_time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                   cache: Optional[dict] = None) -> tuple:
    """The time mix: x ``[B, S, D]`` -> ``(out [B, S, D], new cache)``. With
    ``cache`` (``{"state" [B, H, c, c], "last_x" [B, D]}``) a one-step x is a
    decode step and a longer one a prefill, and the new ``{"state",
    "last_x"}`` is returned; without one, None."""
    H, c = rwkv_dims(cfg)
    B, S, D = x.shape
    decode = cache is not None and "state" in cache and S == 1
    last = cache.get("last_x") if cache else None
    prev = _token_shift(x, last)
    xr, xk, xv, xg, xw = (_lerp(x, prev, p[f"mu_{n}"]) for n in "rkvgw")

    r = _einsum("bsd,de->bse", xr, p["wr"]).reshape(B, S, H, c)
    k = _einsum("bsd,de->bse", xk, p["wk"]).reshape(B, S, H, c)
    v = _einsum("bsd,de->bse", xv, p["wv"]).reshape(B, S, H, c)
    g = F.silu(_einsum("bsd,de->bse", xg, p["wg"]))
    logw = _decay(p, xw).reshape(B, S, H, c)

    new_cache = None
    if decode:
        S_prev = cache["state"]                           # [B, H, c, c]
        r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]            # [B, H, c]
        w1 = torch.exp(logw[:, 0]).to(S_prev.dtype)
        kv = k1[..., :, None] * v1[..., None, :]          # [B, H, c, c]
        y = _einsum("bhc,bhcd->bhd", r1, S_prev + p["u"][None, :, :, None]
                    .to(S_prev.dtype) * kv)
        S_new = w1[..., None] * S_prev + kv
        y = y.reshape(B, 1, D)
        new_cache = {"state": S_new, "last_x": x[:, 0]}
    else:
        chunk = min(64, S)
        pad = (-S) % chunk
        rp, kp, vp, lwp = (F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t
                           for t in (r, k, v, logw))
        init_state = cache.get("state") if cache else None
        if init_state is None:
            y, S_fin = ops.wkv6(rp, kp, vp, lwp, p["u"], chunk)
        else:
            y, S_fin = wkv_chunked(rp, kp, vp, lwp, p["u"], chunk,
                                   init_state=init_state)
        y = y[:, :S].reshape(B, S, D)
        if cache is not None:  # prefill handover
            new_cache = {"state": S_fin, "last_x": x[:, -1]}

    # per-head group norm (ln_x), gate, out
    y32 = y.reshape(B, S, H, c).float()
    mean = y32.mean(-1, keepdim=True)
    var = (y32 - mean).square().mean(-1, keepdim=True)
    yh = ((y32 - mean) * torch.rsqrt(var + 64e-5)).to(y.dtype)
    y = yh.reshape(B, S, D) * p["ln_x"]
    y = y * g
    return _einsum("bse,ed->bsd", y, p["wo"]), new_cache


def rwkv6_channel_mix(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                      cache: Optional[dict] = None) -> tuple:
    """The channel-mix FFN with token shift: x ``[B, S, D]`` -> ``(out,
    new cache)``; with ``cache`` (``{"last_x" [B, D]}``) the new
    ``{"last_x"}``, else None."""
    last = cache.get("last_x") if cache else None
    prev = _token_shift(x, last)
    xk = _lerp(x, prev, p["cm_mu_k"])
    xr = _lerp(x, prev, p["cm_mu_r"])
    k = torch.square(F.relu(_einsum("bsd,df->bsf", xk, p["cm_wk"])))
    kv = _einsum("bsf,fd->bsd", k, p["cm_wv"])
    out = torch.sigmoid(_einsum("bsd,de->bse", xr, p["cm_wr"])) * kv
    return out, ({"last_x": x[:, -1]} if cache is not None else None)
