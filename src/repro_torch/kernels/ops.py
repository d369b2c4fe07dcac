"""Kernel dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version. There are no modes and no
environment variables; the tensor's device (and, for ``attention`` and
``grouped_matmul``, the JAX package's shape condition) decides, and a CUDA
tensor never falls back to the plain version."""

from __future__ import annotations

import torch

from repro_torch.core.ddpg import DDPGConfig, DDPGState
from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain
from repro_torch.kernels.episode_learn import EpisodeKernelSpec, \
    EpisodeOperands, episode_learn, episode_learn_plain
from repro_torch.kernels.flash_attention import flash_attention_bwd, \
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain
from repro_torch.kernels.gmm import gmm, gmm_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.kernels.wkv6_scan import wkv6_scan, wkv6_scan_plain

#: ``attention`` takes sequence lengths that are multiples of this, as the
#: JAX package's ``kernels/ops.py::attention`` routes to its kernel
ATTENTION_BLOCK = 128
#: ``grouped_matmul`` takes the kernel when C, D and F are multiples of this,
#: as the JAX package's ``kernels/ops.py::grouped_matmul`` takes ``gmm``
GMM_ALIGN = 128


def ddpg_inner_loop(state: DDPGState, batches: tuple, *,
                    cfg: DDPGConfig) -> torch.Tensor:
    """All U DDPG updates of N sessions (``kernels.ddpg_learn``): updates
    ``state`` in place, returns the metrics ``[N, U, 3]``."""
    device = state.flat.device
    if device.type == "cuda":
        return ddpg_learn(state, batches, cfg=cfg)
    if device.type == "cpu":
        return ddpg_learn_plain(state, batches, cfg=cfg)
    raise ValueError(f"no DDPG learner for device {device}")


def episode_inner_loop(operands: EpisodeOperands, *,
                       spec: EpisodeKernelSpec):
    """N sessions' whole T-step episodes (``kernels.episode_learn``):
    updates ``operands.carry`` in place, returns the trace."""
    device = operands.carry.ddpg.flat.device
    if device.type == "cuda":
        return episode_learn(operands, spec=spec)
    if device.type == "cpu":
        return episode_learn_plain(operands, spec=spec)
    raise ValueError(f"no episode kernel for device {device}")


class _FlashAttention(torch.autograd.Function):
    """Flash attention in the kernel layout with its gradient. The forward
    and the backward are looked up by their names in this module at each
    call (``flash_attention_fwd``, ``flash_attention_bwd``), so a caller
    may swap what they run. The saved ``q, k, v, out, lse`` go through
    ``ctx.save_for_backward``: under non-reentrant activation checkpointing
    they are those of the recomputed forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cuda":
            out, lse = flash_attention_fwd(q, k, v, causal)
        else:
            out, lse = flash_attention_fwd_plain(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                             ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                   ctx.causal)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Flash attention in the model layout (``kernels.flash_attention``):
    q ``[B, S, H, D]``, k/v ``[B, Sk, Kv, D]`` -> ``[B, S, H, D]``,
    differentiable. Needs ``D >= 8`` and both sequence lengths multiples of
    128; transposes to the kernel layout ``[B, H, S, D]`` and back. On a
    CUDA tensor the forward and the backward are the kernels, on a CPU
    tensor their plain versions."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if S % ATTENTION_BLOCK or Sk % ATTENTION_BLOCK or D < 8:
        raise ValueError(f"flash attention takes sequence lengths that are "
                         f"multiples of {ATTENTION_BLOCK} and a head dim of "
                         f"at least 8, got {S}, {Sk} and {D}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _FlashAttention.apply(qt, kt, vt, causal).transpose(1, 2)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` for x ``[E, C, D]``, w ``[E, D, F]``
    (``kernels.gmm``), on the JAX package's condition: when C, D and F are
    all multiples of 128, a CUDA tensor runs the kernel (``gmm``, looked up
    by name in this module at each call) and a CPU tensor its plain version
    (``gmm_plain``); otherwise ``torch.einsum`` on either device, in the
    promoted type of x and w, as the reference's ``jnp.einsum``.

    The kernel has no gradient yet: an aligned CUDA input that needs one
    raises ``NotImplementedError`` (ROADMAP B4g). On the CPU, autograd
    flows through the plain version and through einsum."""
    C, D, F = x.shape[1], x.shape[2], w.shape[-1]
    if C % GMM_ALIGN or D % GMM_ALIGN or F % GMM_ALIGN:
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.einsum("ecd,edf->ecf", x.to(dt), w.to(dt))
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(
                "gmm has no gradient kernel yet (dx = dy w^T, dw = x^T dy): "
                "ROADMAP B4g")
        return gmm(x.contiguous(), w.contiguous())
    if x.device.type == "cpu":
        return gmm_plain(x, w)
    raise ValueError(f"no grouped matmul for device {x.device}")


def grouped_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``[E, C, D] -> [E, C, D]``, the MoE expert FFN:
    ``silu(x w_gate) * (x w_up)``, then ``w_down``, each product a
    ``grouped_matmul``."""
    g = torch.nn.functional.silu(grouped_matmul(x, w_gate))
    u = grouped_matmul(x, w_up)
    return grouped_matmul(g * u, w_down)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int) -> tuple:
    """The chunked Mamba2 / SSD scan in the model layout
    (``kernels.ssd_scan``): x ``[b, s, h, p]``, dt ``[b, s, h]`` float32
    (after softplus), A ``[h]`` float32, Bm/Cm ``[b, s, n]`` in x's type ->
    ``(y [b, s, h, p]`` in x's type``, state [b, h, n, p]`` float32``)``.
    Folds x and dt to ``[b h, s, ...]`` and A to ``[b h]``, and unfolds the
    results. A CUDA tensor runs the kernel (``ssd_scan``, looked up by name
    in this module at each call), a CPU tensor its plain version
    (``ssd_scan_plain``). ``s`` must be a multiple of ``chunk``, where the
    JAX package's fallback asserts; the port raises ``ValueError``.

    The kernel has no gradient: a CUDA input that needs one raises
    ``NotImplementedError`` (ROADMAP A11f). On the CPU, autograd flows
    through the plain version."""
    b, s, h, p = x.shape
    if s % chunk:
        raise ValueError(f"the SSD scan takes a sequence length that is a "
                         f"multiple of the chunk, got {s} and {chunk}")
    xf = x.transpose(1, 2).reshape(b * h, s, p)
    dtf = dt.transpose(1, 2).reshape(b * h, s)
    Af = A[None, :].expand(b, h).reshape(b * h)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, Bm, Cm)):
            raise NotImplementedError(
                "ssd_scan has no gradient kernel yet: ROADMAP A11f (hybrid "
                "training)")
        y, state = ssd_scan(xf.contiguous(), dtf.contiguous(),
                            Af.contiguous(), Bm.contiguous(), Cm.contiguous(),
                            heads=h, chunk=chunk)
    elif x.device.type == "cpu":
        y, state = ssd_scan_plain(xf, dtf, Af, Bm, Cm, heads=h, chunk=chunk)
    else:
        raise ValueError(f"no SSD scan for device {x.device}")
    n = Bm.shape[-1]
    return y.reshape(b, h, s, p).transpose(1, 2), state.reshape(b, h, n, p)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, chunk: int = 64) -> tuple:
    """The chunked RWKV6 WKV scan in the model layout
    (``kernels.wkv6_scan``): r, k, v ``[B, S, H, c]`` in one type, logw
    ``[B, S, H, c]`` float32 (<= 0), u ``[H, c]`` -> ``(y [B, S, H, c]`` in
    r's type``, state [B, H, c, c]`` float32``)``. Folds to ``[B H, S, c]``
    (u to ``[B H, c]``) and unfolds the results. A CUDA tensor runs the
    kernel (``wkv6_scan``, looked up by name in this module at each call), a
    CPU tensor its plain version (``wkv6_scan_plain``), both at ``chunk``,
    as the JAX package's TPU path runs its kernel. ``S`` must be a multiple
    of ``chunk``; the port raises ``ValueError`` otherwise.

    The kernel has no gradient: a CUDA input that needs one raises
    ``NotImplementedError`` (ROADMAP A11g). On the CPU, autograd flows
    through the plain version."""
    B, S, H, c = r.shape
    if S % chunk:
        raise ValueError(f"the WKV scan takes a sequence length that is a "
                         f"multiple of the chunk, got {S} and {chunk}")

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, c)

    uf = u[None].expand(B, H, c).reshape(B * H, c)
    if r.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, logw, u)):
            raise NotImplementedError(
                "wkv6_scan has no gradient kernel yet: ROADMAP A11g (RWKV6 "
                "training)")
        y, state = wkv6_scan(*(fold(t).contiguous() for t in (r, k, v, logw)),
                             uf.contiguous(), chunk=chunk)
    elif r.device.type == "cpu":
        y, state = wkv6_scan_plain(*(fold(t) for t in (r, k, v, logw)), uf,
                                   chunk=chunk)
    else:
        raise ValueError(f"no WKV scan for device {r.device}")
    return y.reshape(B, H, S, c).transpose(1, 2), state.reshape(B, H, c, c)
