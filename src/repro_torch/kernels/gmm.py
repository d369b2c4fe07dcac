"""Grouped (per-expert) matrix product: the CUDA kernel's wrapper, its plain
PyTorch version, and the work it does.

``gmm(x, w)`` launches ``csrc/gmm.cu`` (one thread block per expert, 64 rows
of C and 64 columns of F, the contraction a loop inside the block; it
replaces the Pallas TPU kernel ``src/repro/kernels/gmm.py:35 gmm`` of the
JAX package). ``gmm_plain`` computes the same function with the TPU
kernel's op order; it is what a CPU tensor runs (``kernels.ops``) and what
the kernel is held against on the card.

Both take x ``[E, C, D]`` and w ``[E, D, F]`` and return
``out[e] = x[e] @ w[e]`` ``[E, C, F]`` in x's type, summed in float32.

Bound (``work``): the operations over the card's bf16 tensor rate
(989 TFLOP/s) or the bytes over 3.35 TB/s, whichever is larger; the
kernel's own products run on the float32 CUDA cores (67 TFLOP/s).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: the kernel's tile: C and F are multiples of these, D of ``CHUNK``
BLOCK_C = 64
BLOCK_F = 64
CHUNK = 32
#: the TPU kernel's contraction block (``block_d = min(512, D)``)
PLAIN_BLOCK_D = 512
DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Validate ranks, shapes, dtypes and devices; return ``(E, C, D, F)``."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[1] != D:
        raise ValueError(f"w must be [{E}, {D}, F] for x {tuple(x.shape)}, "
                         f"got {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise ValueError(f"x and w must be of {DTYPES}, got {x.dtype}, "
                         f"{w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    return E, C, D, w.shape[2]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.gmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` in ONE launch of the CUDA kernel, on
    ``torch.cuda.current_stream()``.

    Raises on tensors the kernel does not take (not on the card, other or
    mixed dtypes, C or F not a multiple of 64, D not a multiple of 32, a
    non-contiguous layout) and on a refused launch; it never runs the plain
    version. It has no gradient (``kernels.ops.grouped_matmul`` refuses a
    CUDA input that needs one). ``gmm.launches`` counts launches."""
    E, C, D, F = _check(x, w)
    if not x.is_cuda:
        raise ValueError("gmm launches the CUDA kernel and takes CUDA "
                         "tensors; use gmm_plain on the CPU")
    if w.dtype != x.dtype:
        raise ValueError(f"the kernel takes x and w of one dtype, got "
                         f"{x.dtype}, {w.dtype}")
    if C % BLOCK_C or F % BLOCK_F or D % CHUNK:
        raise ValueError(f"the kernel takes C and F that are multiples of "
                         f"{BLOCK_C} and D a multiple of {CHUNK}, got C {C}, "
                         f"D {D}, F {F}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _bind(build.load("gmm"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), E,
                             C, D, F, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"gmm: kernel launch failed with CUDA error {err}")
    gmm.launches += 1
    return out


gmm.launches = 0


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in the TPU kernel's op order:
    over blocks of ``min(512, D)`` of the contraction, in order (the last
    one partial where 512 does not divide D), ``acc += x_blk.float() @
    w_blk.float()`` from a float32 zero, then one cast to x's type.
    Differentiable. On the card its float32 products must not run in TF32,
    so it refuses to run when TF32 is on."""
    E, C, D, F = _check(x, w)
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("gmm_plain needs full float32 products: turn "
                           "TF32 off")
    block = min(PLAIN_BLOCK_D, D)
    acc = torch.zeros((E, C, F), dtype=torch.float32, device=x.device)
    for d0 in range(0, D, block):
        acc = acc + torch.bmm(x[:, :, d0:d0 + block].float(),
                              w[:, d0:d0 + block].float())
    return acc.to(x.dtype)


def work(E: int, C: int, D: int, F: int, itemsize: int = 2) -> dict:
    """Operations and device-memory bytes one call must spend, from the
    shapes alone: ``2 E C D F`` operations (a multiply-add counts 2); x and
    w read once and out written once, ``itemsize`` bytes each."""
    return {"flops": 2 * E * C * D * F,
            "bytes": itemsize * (E * C * D + E * D * F + E * C * F)}
