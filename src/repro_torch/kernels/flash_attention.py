"""Causal GQA flash attention, forward: the CUDA kernel's wrapper, its plain
PyTorch version, and the work it does.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (one
thread block per batch row, head and block of 64 queries, the key/value
tiles a loop inside the block; it replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:84 _flash_fwd`` of the JAX package).
``flash_attention_fwd_plain`` computes the same function with the TPU
kernel's numerics (float32 scores from q upcast and pre-scaled, float32
``p`` into ``p v``) and materializes the scores; it is what a CPU tensor
runs (``kernels.ops.attention``) and what the kernel is held against on the
card.

Both take the kernel layout, q ``[B, H, Sq, D]`` and k, v ``[B, Kv, Sk, D]``
(H a multiple of Kv; query head h reads key/value head ``h // (H // Kv)``),
float32 or bfloat16, contiguous, and return ``(out [B, H, Sq, D]`` in q's
type, ``lse [B, H, Sq]`` float32``)``. The causal mask compares absolute
positions from 0 (``kpos <= qpos``).

Bound (``work``): the operations over the card's bf16 tensor rate (989
TFLOP/s) or the bytes over 3.35 TB/s, whichever is larger; the kernel's own
products run on the float32 CUDA cores (67 TFLOP/s).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

BLOCK_Q = 64
BLOCK_K = 64
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Validate layout, dtypes, devices and contiguity; return
    ``(B, H, Kv, Sq, Sk, D)``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, H, Sq, D] and k, v [B, Kv, Sk, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, H, Sq, D = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Kv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, Kv, Sk, {D}] alike, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if Kv == 0 or H % Kv:
        raise ValueError(f"{H} query heads are not a multiple of {Kv} "
                         f"key/value heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    return B, H, Kv, Sq, Sk, D


def _check_kernel(q, k, v) -> tuple:
    """What the CUDA kernel takes beyond ``_check``."""
    dims = _check(q, k, v)
    _, _, _, Sq, Sk, D = dims
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head dim that is a multiple of "
                         f"8 in [8, {MAX_HEAD_DIM}], got {D}")
    if Sq % BLOCK_Q or Sk % BLOCK_K:
        raise ValueError(f"the kernel takes sequence lengths that are "
                         f"multiples of {BLOCK_Q}, got {Sq} and {Sk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dims


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def scale_of(D: int) -> np.float32:
    """The softmax scale ``1 / sqrt(D)`` as the float32 the TPU kernel
    multiplies by."""
    return np.float32(1.0 / math.sqrt(D))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> tuple:
    """Run the forward pass in ONE launch of the CUDA kernel, on
    ``torch.cuda.current_stream()``. Returns ``(out, lse)``.

    Raises on a tensor the kernel does not take (not on the card, another
    dtype, a head dim that is not a multiple of 8 in [8, 128], a sequence
    length that is not a multiple of 64, a non-contiguous layout) and on a
    refused launch; it never runs the plain version.
    ``flash_attention_fwd.launches`` counts launches."""
    B, H, Kv, Sq, Sk, D = _check_kernel(q, k, v)
    if not q.is_cuda:
        raise ValueError("flash_attention_fwd launches the CUDA kernel and "
                         "takes CUDA tensors; use flash_attention_fwd_plain "
                         "on the CPU")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _bind(build.load("flash_attention_fwd"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Kv, Sq, Sk, D, int(causal),
            int(q.dtype == torch.bfloat16), scale_of(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True) -> tuple:
    """The same function in plain PyTorch, with the TPU kernel's numerics:
    scores in float32 from q upcast and multiplied by the float32 scale, an
    exact softmax over each row (the online one's result), ``p`` in float32
    into ``p v``, ``out = acc / max(l, 1e-30)`` cast to q's type,
    ``lse = m + log(max(l, 1e-30))`` and 0 for a row that saw no key.
    Materializes the ``[B, H, Sq, Sk]`` scores. On the card its float32
    products must not run in TF32, so it refuses to run when TF32 is on."""
    B, H, Kv, Sq, Sk, D = _check(q, k, v)
    if q.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("flash_attention_fwd_plain needs full float32 "
                           "products: turn TF32 off")
    g = H // Kv
    qf = (q.float() * float(scale_of(D))).reshape(B, Kv, g, Sq, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2))           # [B, Kv, g, Sq, Sk]
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s.masked_fill_(kpos > qpos, -math.inf)
    m = s.amax(dim=-1)
    finite = torch.isfinite(m)
    safe = torch.where(finite, m, torch.zeros_like(m))
    # p overwrites the scores: one [B, H, Sq, Sk] buffer at a time
    p = s.sub_(safe[..., None]).exp_().masked_fill_(~finite[..., None], 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.matmul(p, vf)
    out = (acc / l[..., None]).to(q.dtype).reshape(B, H, Sq, D)
    lse = torch.where(finite, m + torch.log(l), torch.zeros_like(m))
    return out, lse.reshape(B, H, Sq)


def work(B: int, H: int, Kv: int, S: int, D: int, causal: bool,
         itemsize: int) -> dict:
    """Operations and device-memory bytes one forward call must spend at
    ``Sq = Sk = S``, from the shapes alone. Operations: 4 D per query-key
    pair (2 D for ``q k``, 2 D for ``p v``; a multiply-add counts 2), over
    the S (S + 1) / 2 pairs each causal row sees, or S^2. Bytes: q, k, v
    read once, out written once (``itemsize`` bytes each), lse written once
    (float32)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return {"flops": 4 * B * H * D * pairs,
            "bytes": itemsize * (2 * B * H * S * D + 2 * B * Kv * S * D)
            + 4 * B * H * S}
