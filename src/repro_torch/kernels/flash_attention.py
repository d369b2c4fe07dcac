"""Causal GQA flash attention, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions, and the work they do.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu``, which
replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:84
_flash_fwd`` of the JAX package. Which dtype takes which kernel:

- **bfloat16** (what serving and training run): ``flash_fwd_tc_kernel``.
  One block per (batch row, head, 128 queries); TMA loads the q tile once
  and 128-key tiles of k and v into a ring of ``TC_STAGES`` stages (the
  128-byte swizzle, the head dim zero-filled to 128). Two consumer
  warpgroups of 64 rows sum the scores ``(q scale) k^T`` on the CUDA cores
  in this module's plain version's own float32 order (so that they are its
  scores bit for bit: on random-weight serving layers any other order
  misses the card's bound), and compute ``p v`` with ``wgmma.mma_async``
  m64n128k16 on the tensor cores, p from registers as three bf16 terms
  that hold the float32 p exactly (``tests/test_torch_flash.py`` pins
  why).
- **float32**: ``flash_fwd_kernel``, float32 FMAs on the CUDA cores (one
  block per batch row, head and block of 64 queries, the key/value tiles a
  loop inside the block). A tensor-core float32 product would be TF32,
  which the port never uses.

A bf16 CUDA tensor never reaches the CUDA-core kernel or the plain version.
``flash_attention_fwd_plain`` computes the same function with the TPU
kernel's numerics (float32 scores from q upcast and pre-scaled, float32
``p`` into ``p v``) and materializes the scores; it is what a CPU tensor
runs (``kernels.ops.attention``) and what the kernel is held against on the
card.

``flash_attention_bwd`` computes ``delta = rowsum(dout * out)`` in plain
PyTorch, as the JAX package does outside its kernels, then launches the two
kernels of ``csrc/flash_attention_bwd.cu``: ``flash_attention_dq`` (replaces
``_dq_kernel``, ``flash_attention.py:124``) and ``flash_attention_dkv``
(dk and dv, looping over the GQA group's query heads; replaces
``_dkv_kernel``, ``flash_attention.py:160``). Which dtype takes which
kernels:

- **bfloat16** (what training runs): ``flash_dq_tc_kernel`` (one block per
  batch row, query head and 128 queries; k and v tiles of 64 keys through a
  TMA ring of ``BWD_TC_STAGES["dq"]`` stages) and ``flash_dkv_tc_kernel``
  (one block per batch row, key/value head and 128 keys; q and do tiles of
  64 queries through ``BWD_TC_STAGES["dkv"]`` stages). Two consumer
  warpgroups of 64 rows sum s and dp on the CUDA cores in this module's
  plain version's own float32 order (on random-weight training layers
  ``ds = p (dp - delta)`` cancels, so both must be its values bit for bit),
  and run dv, dk and dq with ``wgmma.mma_async`` m64n128k16 on the tensor
  cores, p and ds (times 2^24) from registers as three bf16 terms that
  hold them exactly (``tests/test_torch_flash_bwd.py`` pins why).
- **float32**: ``flash_dq_kernel`` and ``flash_dkv_kernel``, float32 FMAs
  on the CUDA cores (blocks of 64 queries or keys). A tensor-core float32
  product would be TF32, which the port never uses.

``flash_attention_bwd_plain`` is their plain version, in their op order.

All take the kernel layout, q ``[B, H, Sq, D]`` and k, v ``[B, Kv, Sk, D]``
(H a multiple of Kv; query head h reads key/value head ``h // (H // Kv)``),
float32 or bfloat16, contiguous. The forward returns ``(out [B, H, Sq, D]``
in q's type, ``lse [B, H, Sq]`` float32``)``; the backward takes out, lse
and ``dout`` (out's shape and type) and returns ``(dq, dk, dv)`` in the
types of q, k, v. The causal mask compares absolute positions from 0
(``kpos <= qpos``).

Bounds (``work``, ``work_bwd``): the operations over the card's bf16 tensor
rate (989 TFLOP/s) or the bytes over 3.35 TB/s, whichever is larger. The
bf16 forward sums its 2 D operations per query-key pair for the scores on
the float32 CUDA cores (67 TFLOP/s) and issues 6 D tensor operations for
``p v`` where ``work`` counts 2 D (the three terms of p are the precision
plan's cost, not work); the bf16 backward sums s and dp (4 D per pair of
``work_bwd``'s 6 D and 8 D) on the CUDA cores and issues the rest as
three-term tensor products.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build

#: what the kernels take: Sq and Sk multiples of these (the float32
#: kernel's tiles; the tensor-core kernel zero-fills a tile that runs past
#: Sq or Sk and masks the keys past Sk)
BLOCK_Q = 64
BLOCK_K = 64
MAX_HEAD_DIM = 128
#: the tensor-core kernel's block (queries) and key tile, its ring of
#: stages, and the bytes TMA needs a pointer aligned to
TC_BLOCK = (128, 128)
TC_STAGES = 2
TMA_ALIGN = 16
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


def tc_smem_plan(stages: int = TC_STAGES) -> dict:
    """Bytes of dynamic shared memory one tensor-core block asks for, by
    part, in the order the parts lie (``csrc/flash_attention_fwd.cu``,
    ``tc_smem_bytes``), with the ``total``: slack to align to the swizzle's
    1,024-byte atom, q times the scale in float32 (128 rows of the head dim
    zero-filled to 128), per stage a k and a v tile (128 keys each, bf16),
    the bf16 q tile, whose place then holds each consumer warp's buffer for
    the exchange of its scores (16 query rows by 64 keys, float32), then a
    full and an empty mbarrier per stage and the q tile's."""
    queries, keys = TC_BLOCK
    plan = {"alignment slack": 1024,
            "q scale, float32": queries * MAX_HEAD_DIM * 4,
            "k, v tiles": stages * 2 * keys * MAX_HEAD_DIM * 2,
            "q tile, then the score exchange": queries * MAX_HEAD_DIM * 2,
            "mbarriers": (2 * stages + 1) * 8}
    plan["total"] = sum(plan.values())
    return plan


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.flash_attention_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_fwd_tc_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_fwd_tc_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_fwd_tc_stages.argtypes = []
        lib.flash_attention_fwd_tc_stages.restype = ctypes.c_int
    return lib


def scale_of(D: int) -> np.float32:
    """The softmax scale ``1 / sqrt(D)`` as the float32 the TPU kernel
    multiplies by."""
    return np.float32(1.0 / math.sqrt(D))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> tuple:
    """Run the forward pass in ONE launch of a CUDA kernel, on
    ``torch.cuda.current_stream()``: bfloat16 by ``flash_fwd_tc_kernel``
    (TMA, the scores on the CUDA cores, ``p v`` by ``wgmma``), float32 on
    the CUDA cores (``flash_fwd_kernel``). Returns ``(out, lse)``.

    Raises on a tensor the kernels do not take (not on the card, another
    dtype, a head dim that is not a multiple of 8 in [8, 128], a sequence
    length that is not a multiple of 64, a non-contiguous layout, a
    bfloat16 tensor not 16-byte aligned for TMA) and on a refused launch;
    it never runs the plain version. ``flash_attention_fwd.launches``
    counts launches."""
    B, H, Kv, Sq, Sk, D = _check_kernel(q, k, v)
    if not q.is_cuda:
        raise ValueError("flash_attention_fwd launches the CUDA kernel and "
                         "takes CUDA tensors; use flash_attention_fwd_plain "
                         "on the CPU")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(f"{name} must start {TMA_ALIGN}-byte "
                                 f"aligned (TMA), got {t.data_ptr():#x}")
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


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

#: dynamic shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448
#: row stride (floats) of the float32 backward's transposed tiles and p / ds
SMEM_LD = 68
#: the stages of the bf16 backward kernels' TMA rings
BWD_TC_STAGES = {"dq": 2, "dkv": 2}


def bwd_tc_smem_plan(stages: dict | None = None) -> dict:
    """Bytes of dynamic shared memory one block of each bf16 (tensor-core)
    backward kernel asks for, by part, in the order the parts lie
    (``csrc/flash_attention_bwd.cu``, ``dq_tc_smem_bytes`` and
    ``dkv_tc_smem_bytes``), with the ``total`` of each; ``stages`` maps
    ``"dq"`` and ``"dkv"`` to their rings' stages (default
    ``BWD_TC_STAGES``). Both kernels zero-fill the head dim to 128 and own
    128 rows; a streamed tile has 64 rows. dq: slack to align to the
    swizzle's 1,024-byte atom, q times the scale and do in float32, the
    consumer warps' buffers for the exchange of s and dp (16 rows by 64
    columns, float32, each), per stage a k and a v tile (bf16; the bf16 q
    and do tiles land in the first two stages before the ring starts), a
    full and an empty mbarrier per stage, the q and do tiles' and their
    landing place's. dk/dv: the slack, the bf16 k and v tiles, the exchange
    buffers, q times the scale and do of a query tile in float32, per stage
    a q and a do tile (bf16), the tile's lse and delta, a full and an empty
    mbarrier per stage and the k and v tiles'."""
    stages = {**BWD_TC_STAGES, **(stages or {})}
    rows, tile, d = 128, 64, MAX_HEAD_DIM
    exchange = 8 * 16 * tile * 4
    dq = {"alignment slack": 1024,
          "q scale, do, float32": 2 * rows * d * 4,
          "s and dp exchange": exchange,
          "k, v tiles (first the q, do tiles)":
              stages["dq"] * 2 * tile * d * 2,
          "mbarriers": (2 * stages["dq"] + 2) * 8}
    dkv = {"alignment slack": 1024,
           "k, v tiles": 2 * rows * d * 2,
           "s and dp exchange": exchange,
           "q scale, do of a tile, float32": 2 * tile * d * 4,
           "q, do tiles": stages["dkv"] * 2 * tile * d * 2,
           "lse, delta of a tile": 2 * tile * 4,
           "mbarriers": (2 * stages["dkv"] + 1) * 8}
    return {name: {**parts, "total": sum(parts.values())}
            for name, parts in (("dq", dq), ("dkv", dkv))}


def bwd_smem_plan(D: int) -> dict:
    """Bytes of dynamic shared memory one block of each backward kernel uses
    at head dim ``D``, by part, with the ``total`` of each: the float32
    kernels' (``"dq"``, ``"dkv"``; in the order the parts lie in shared
    memory, ``csrc/flash_attention_bwd.cu``, ``dq_smem_floats`` and
    ``dkv_smem_floats``) and the bf16 tensor-core kernels' (``"dq_tc"``,
    ``"dkv_tc"``: ``bwd_tc_smem_plan``, the same at every D)."""
    transposed = 4 * D * SMEM_LD           # a [d][row] float32 tile
    rows = 4 * BLOCK_K * D                 # a [row][d] float32 tile
    square = 4 * BLOCK_Q * SMEM_LD         # the p / ds tile
    stats = 4 * 2 * BLOCK_Q                # lse and delta of the rows
    dq = {"q_s, do, k, v transposed": 4 * transposed, "k rows": rows,
          "dq accumulator": rows, "ds transposed": square,
          "lse, delta": stats}
    dkv = {"k, v transposed": 2 * transposed,
           "q_s then do transposed": transposed,
           "do then q_s / scale rows": rows, "dk, dv accumulators": 2 * rows,
           "p then ds": square, "lse, delta": stats}
    plan = {name: {**parts, "total": sum(parts.values())}
            for name, parts in (("dq", dq), ("dkv", dkv))}
    plan.update({f"{name}_tc": parts
                 for name, parts in bwd_tc_smem_plan().items()})
    return plan


def check_bwd_smem_fit(D: int) -> dict:
    """``bwd_smem_plan(D)``; raises ``ValueError`` when a kernel's block
    would need more than the ``SMEM_LIMIT`` bytes a block may use."""
    plan = bwd_smem_plan(D)
    for name, parts in plan.items():
        if parts["total"] > SMEM_LIMIT:
            top = sorted(((v, k) for k, v in parts.items() if k != "total"),
                         reverse=True)[:3]
            raise ValueError(
                f"flash_attention_{name}: {parts['total']:,} B of shared "
                f"memory per block at head dim {D}, over the "
                f"{SMEM_LIMIT:,} B a block may use (largest parts: "
                + ", ".join(f"{k} {v:,} B" for v, k in top) + ")")
    return plan


def _check_bwd(q, k, v, out, lse, dout) -> tuple:
    """``_check`` plus out, dout (q's shape and type) and lse (float32
    ``[B, H, Sq]``) on q's device."""
    dims = _check(q, k, v)
    B, H, _, Sq, _, _ = dims
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, "
                             f"{q.dtype}), got {tuple(t.shape)}, {t.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {H}, {Sq}], got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    for t in (out, lse, dout):
        if t.device != q.device:
            raise ValueError(f"out, lse, dout must lie on q's device "
                             f"{q.device}, got {t.device}")
    return dims


def _check_bwd_kernel(q, k, v, dout, lse, delta) -> tuple:
    """What the backward kernels take: ``_check_kernel``, a contiguous
    dout, float32 contiguous lse and delta, CUDA tensors, a block that fits
    in shared memory, and for bfloat16 (TMA) q, k, v, dout 16-byte
    aligned."""
    _check_bwd(q, k, v, dout, lse, dout)       # dout and lse against q
    dims = _check_kernel(q, k, v)
    if tuple(delta.shape) != tuple(lse.shape) or \
            delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError(f"delta must be float32 {tuple(lse.shape)} on "
                         f"{q.device}, got {tuple(delta.shape)} "
                         f"{delta.dtype} on {delta.device}")
    for name, t in (("dout", dout), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_cuda:
        raise ValueError("the flash backward kernels take CUDA tensors; use "
                         "flash_attention_bwd_plain on the CPU")
    check_bwd_smem_fit(dims[-1])
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            if t.data_ptr() % TMA_ALIGN:
                raise ValueError(f"{name} must start {TMA_ALIGN}-byte "
                                 f"aligned (TMA), got {t.data_ptr():#x}")
    return dims


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the backward library's
    functions: the two launchers; ``flash_attention_bwd_smem_bytes(D,
    which)``, the bytes of one float32 block (0 = dq, 1 = dk/dv);
    ``flash_attention_bwd_tc_smem_bytes(which, stages)``, those of one
    tensor-core block; ``flash_attention_bwd_tc_stages(which)``, the stages
    each tensor-core kernel is built with."""
    for name, outputs in (("flash_attention_dq_launch", 1),
                          ("flash_attention_dkv_launch", 2)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * (6 + outputs) + \
                [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for name, args in (("flash_attention_bwd_smem_bytes", 2),
                       ("flash_attention_bwd_tc_smem_bytes", 2),
                       ("flash_attention_bwd_tc_stages", 1)):
        getattr(lib, name).argtypes = [ctypes.c_int] * args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _launch_bwd(name: str, q, k, v, dout, lse, delta, outputs, dims,
                causal: bool) -> None:
    B, H, Kv, Sq, Sk, D = dims
    lib = bind_bwd(build.load("flash_attention_bwd"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"flash_attention_{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outputs), B, H, Kv, Sq, Sk, D,
            int(causal), int(q.dtype == torch.bfloat16), scale_of(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_{name}: kernel launch failed "
                           f"with CUDA error {err}")


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool = True):
    """dq in ONE launch on the current stream (bfloat16:
    ``flash_dq_tc_kernel``; float32: ``flash_dq_kernel``), from ``delta =
    rowsum(dout * out)`` (float32 ``[B, H, Sq]``). Raises on a tensor the
    kernel does not take and on a refused launch.
    ``flash_attention_dq.launches`` counts launches."""
    dims = _check_bwd_kernel(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel():
        _launch_bwd("dq", q, k, v, dout, lse, delta, (dq,), dims, causal)
        flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, dout, lse, delta, causal: bool = True):
    """``(dk, dv)`` in ONE launch (bfloat16: ``flash_dkv_tc_kernel``;
    float32: ``flash_dkv_kernel``); as ``flash_attention_dq`` otherwise.
    ``flash_attention_dkv.launches`` counts launches."""
    dims = _check_bwd_kernel(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch_bwd("dkv", q, k, v, dout, lse, delta, (dk, dv), dims, causal)
        flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True):
    """The backward pass on the card: ``delta = rowsum(dout * out)`` in
    float32 (plain PyTorch), then one launch of each kernel,
    ``flash_attention_dq`` and ``flash_attention_dkv``. Returns
    ``(dq, dk, dv)``. Raises on a tensor the kernels do not take (not on the
    card, another dtype, a head dim that is not a multiple of 8 in
    [8, 128], a sequence length that is not a multiple of 64, a
    non-contiguous layout, a bfloat16 tensor not 16-byte aligned for TMA)
    and on a refused launch; it never runs the plain version.
    ``flash_attention_bwd.launches`` counts calls (each launches both
    kernels). Range: the bfloat16 kernels sum p and ds times 2^24 (so that
    their three bf16 terms are exact), so a gradient or partial sum above
    2^128 / 2^24 ~ 2.0e31 overflows to inf, where the float32 plain
    version reaches ~3.4e38."""
    _check_bwd(q, k, v, out, lse, dout)
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd launches the CUDA kernels and "
                         "takes CUDA tensors; use flash_attention_bwd_plain "
                         "on the CPU")
    delta = (dout.float() * out.float()).sum(-1)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, causal)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _bwd_plain(q, k, v, dout, lse, delta, causal: bool, want_dq: bool,
               want_dkv: bool) -> tuple:
    """The plain backward from ``delta``: ``(dq, dk, dv)``, None for the
    parts not wanted; see ``flash_attention_bwd_plain``."""
    B, H, Kv, Sq, Sk, D = _check_bwd(q, k, v, dout, lse, dout)
    if q.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("flash_attention_bwd_plain needs full float32 "
                           "products: turn TF32 off")
    g = H // Kv
    # a tensor, not a Python float: the card multiplies by the reciprocal
    # of a Python-float divisor
    scale = torch.tensor(scale_of(D), device=q.device)
    qs = (q.float() * scale).reshape(B, Kv, g, Sq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = dout.float().reshape(B, Kv, g, Sq, D)
    s = torch.matmul(qs, kf.transpose(-1, -2))           # [B, Kv, g, Sq, Sk]
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s.masked_fill_(kpos > qpos, -math.inf)
    p = s.sub_(lse.reshape(B, Kv, g, Sq, 1)).exp_()      # in place of s
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2).to(v.dtype) \
        if want_dkv else None
    ds = torch.matmul(dof, vf.transpose(-1, -2)).sub_(
        delta.reshape(B, Kv, g, Sq, 1)).mul_(p)
    del p
    dq = dk = None
    if want_dq:
        dq = (torch.matmul(ds, kf) * scale).reshape(B, H, Sq, D).to(q.dtype)
    if want_dkv:
        dk = (torch.matmul(ds.transpose(-1, -2), qs / scale) * scale) \
            .sum(dim=2).to(k.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True):
    """The backward in plain PyTorch, in the TPU kernels' op order:
    ``delta = rowsum(dout * out)`` (float32), ``q_s = q * scale``,
    ``p = exp(q_s k^T - lse)`` (masked entries 0), ``dp = do v^T``,
    ``ds = p (dp - delta)``, ``dq = (ds k) * scale``,
    ``dv = sum_heads p^T do`` and ``dk = sum_heads (ds^T (q_s / scale)) *
    scale``, each cast once to its input's type. Materializes
    ``[B, H, Sq, Sk]`` float32 tensors. On the card its float32 products
    must not run in TF32, so it refuses to run when TF32 is on. Returns
    ``(dq, dk, dv)``."""
    _check_bwd(q, k, v, out, lse, dout)
    delta = (dout.float() * out.float()).sum(-1)
    return _bwd_plain(q, k, v, dout, lse, delta, causal, True, True)


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """``flash_attention_dq``'s plain version: dq alone, from delta."""
    return _bwd_plain(q, k, v, dout, lse, delta, causal, True, False)[0]


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal: bool = True):
    """``flash_attention_dkv``'s plain version: ``(dk, dv)``, from delta."""
    return _bwd_plain(q, k, v, dout, lse, delta, causal, False, True)[1:]


def work_bwd(B: int, H: int, Kv: int, S: int, D: int, causal: bool,
             itemsize: int) -> dict:
    """Operations and device-memory bytes of the backward at ``Sq = Sk =
    S``, from the shapes alone, per kernel and for a single-pass backward.
    Per query-key pair (a multiply-add counts 2): ``dq`` needs ``s``,
    ``dp`` and ``ds k`` (6 D); ``dkv`` needs ``s``, ``dp``, ``p^T do`` and
    ``ds^T q`` (8 D); one pass computing all three needs 10 D. Bytes: each
    input read once, each output written once: ``dq`` reads q, k, v, do,
    lse, delta and writes dq; ``dkv`` reads the same and writes dk, dv;
    ``single_pass`` reads q, k, v, do, lse, delta and writes dq, dk, dv."""
    pairs = S * (S + 1) // 2 if causal else S * S
    q_bytes = itemsize * B * H * S * D
    kv_bytes = itemsize * B * Kv * S * D
    stats = 2 * 4 * B * H * S
    reads = 2 * q_bytes + 2 * kv_bytes + stats
    return {"dq": {"flops": 6 * B * H * D * pairs,
                   "bytes": reads + q_bytes},
            "dkv": {"flops": 8 * B * H * D * pairs,
                    "bytes": reads + 2 * kv_bytes},
            "single_pass": {"flops": 10 * B * H * D * pairs,
                            "bytes": reads + q_bytes + 2 * kv_bytes}}
