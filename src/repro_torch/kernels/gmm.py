"""Grouped (per-expert) matrix product: the CUDA kernels' wrapper, their
plain PyTorch version, and the work they do.

``gmm(x, w)`` launches ``csrc/gmm.cu``, which replaces the Pallas TPU
kernel ``src/repro/kernels/gmm.py:35 gmm`` of the JAX package. Which dtype
takes which kernel:

- **bfloat16** (what serving runs): ``gmm_tc_kernel``, on the tensor cores.
  One block per (expert, 128 rows of C, 128 columns of F); TMA copies 64-deep
  K steps of x and w into a ring of ``STAGES`` stages in shared memory (the
  128-byte swizzle), and two consumer warpgroups sum them with
  ``wgmma.mma_async`` m64n128k16 (f32 += bf16 x bf16) into registers.
- **float32**: ``gmm_kernel``, float32 FMAs on the CUDA cores (one block per
  64 x 64 tile, 32-deep chunks). A tensor-core float32 product would be
  TF32, which the port never uses.

A bf16 CUDA tensor never reaches the CUDA-core kernel or ``gmm_plain``.
``gmm_plain`` computes the same function with the TPU kernel's op order; it
is what a CPU tensor runs (``kernels.ops``) and what the kernel is held
against on the card.

Both take x ``[E, C, D]`` and w ``[E, D, F]`` and return
``out[e] = x[e] @ w[e]`` ``[E, C, F]`` in x's type, summed in float32.

Bound (``work``): the operations over the card's bf16 tensor rate
(989 TFLOP/s) or the bytes over 3.35 TB/s, whichever is larger.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: what the kernels take: C and F multiples of these, D of ``CHUNK`` (the
#: float32 kernel's tile; the tensor-core kernel zero-fills a tile that runs
#: past C, D or F)
BLOCK_C = 64
BLOCK_F = 64
CHUNK = 32
#: the tensor-core kernel's block tile (rows of C, columns of F, depth of one
#: K step), its ring of stages, and the bytes TMA needs a pointer aligned to
TC_TILE = (128, 128, 64)
STAGES = 4
TMA_ALIGN = 16
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


def smem_plan(stages: int = STAGES) -> dict:
    """Bytes of dynamic shared memory one tensor-core block asks for, by
    part, in the order the parts lie (``csrc/gmm.cu``, ``tc_smem_bytes``),
    with the ``total``: slack to align the ring to the swizzle's 1,024-byte
    atom, then per stage the x tile (128 rows of 128 bytes) and two w boxes
    (64 depths of 128 bytes each), then a full and an empty mbarrier per
    stage."""
    rows, cols, depth = TC_TILE
    plan = {"alignment slack": 1024,
            "x tiles": stages * rows * depth * 2,
            "w boxes": stages * depth * cols * 2,
            "mbarriers": stages * 2 * 8}
    plan["total"] = sum(plan.values())
    return plan


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.gmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("gmm_smem_bytes", "gmm_stages"):
            getattr(lib, name).restype = ctypes.c_int
        lib.gmm_smem_bytes.argtypes = [ctypes.c_int]
        lib.gmm_stages.argtypes = []
    return lib


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]`` in ONE launch of a CUDA kernel, on
    ``torch.cuda.current_stream()``: bfloat16 on the tensor cores
    (``gmm_tc_kernel``, TMA + ``wgmma``), float32 on the CUDA cores
    (``gmm_kernel``).

    Raises on tensors the kernels do not take (not on the card, other or
    mixed dtypes, C or F not a multiple of 64, D not a multiple of 32, a
    non-contiguous layout, a bfloat16 tensor not 16-byte aligned for TMA)
    and on a refused launch; it never runs the plain version. It has no
    gradient (``kernels.ops.grouped_matmul`` refuses a CUDA input that
    needs one). ``gmm.launches`` counts launches."""
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
        if t.dtype == torch.bfloat16 and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} must start {TMA_ALIGN}-byte aligned "
                             f"(TMA), got {t.data_ptr():#x}")
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
