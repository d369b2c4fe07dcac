"""Chunked Mamba2 / SSD scan: the CUDA kernel's wrapper, its plain PyTorch
version, the work it does and its shared-memory plans.

``ssd_scan(x, dt, A, Bm, Cm, heads=, chunk=)`` launches ``csrc/ssd_scan.cu``
(it replaces the Pallas TPU kernel ``src/repro/kernels/mamba2_scan.py:69
ssd_scan`` of the JAX package): in bfloat16 ``ssd_scan_tc_kernel``, a
persistent block per SM taking (batch-head row, chunk) tiles by ticket,
the products on the tensor cores (``wgmma``), the chunks of a row in
parallel and only the carried state passed from tile to tile; in float32
``ssd_scan_kernel``, one block per row on the CUDA cores, the chunks a loop
inside the block. ``ssd_scan_plain`` computes the same function with the
TPU kernel's op order, one chunk at a time over all rows at once; it is what a
CPU tensor runs (``kernels.ops.ssd``) and what the kernel is held against
on the card.

Layouts (the reference's): x ``[BH, S, P]`` float32 or bfloat16; dt
``[BH, S]`` float32 (after softplus); A ``[BH]`` float32 (negative); Bm and
Cm ``[B, S, N]`` in x's type, row ``bh`` reading batch ``bh // heads``.
Both return ``(y [BH, S, P]`` in x's type``, state [BH, N, P]`` float32``)``.

Bound (``work``): the operations over the card's bf16 tensor rate
(989 TFLOP/s) or the bytes over 3.35 TB/s, whichever is larger.
``tc_operations`` counts what the bf16 kernel issues on the tensor cores.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: rows (and columns) of the kernel's score sub-tile; the chunk is taken in
#: sub-tiles of this many rows, the last one partial
TILE = 64
#: padding (floats) of the kernel's transposed B and C rows
PAD = 8
MAX_CHUNK = 256
#: the largest state dim N and head dim P (both multiples of 4)
MAX_NP = 64
SMEM_LIMIT = 232_448
DTYPES = (torch.float32, torch.bfloat16)
#: bf16 terms of each float32 operand of the tensor-core kernel's products
#: (the decayed scores, the carried state, x w): three hold it exactly
TC_TERMS = 3
#: a carried state of the tensor-core kernel, N and P zero-filled to 64
TC_SLOT = 64 * 64


def _check(x, dt, A, Bm, Cm, heads: int, chunk: int) -> tuple:
    """Validate ranks, shapes, dtypes, devices and the chunk; return
    ``(BH, S, P, N)``."""
    if x.dim() != 3 or dt.dim() != 2 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"x must be [BH, S, P], dt [BH, S], A [BH] and Bm, "
                         f"Cm [B, S, N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    BH, S, P = x.shape
    N = Bm.shape[-1]
    if heads <= 0 or BH % heads:
        raise ValueError(f"{BH} rows are not a multiple of {heads} heads")
    if tuple(dt.shape) != (BH, S) or tuple(A.shape) != (BH,):
        raise ValueError(f"dt must be [{BH}, {S}] and A [{BH}], got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if tuple(Bm.shape) != (BH // heads, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be [{BH // heads}, {S}, N] alike, "
                         f"got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm, Cm must share one of {DTYPES}, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, "
                         f"{A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm, Cm must lie on one device")
    if chunk < 1 or S % chunk:
        raise ValueError(f"the chunk {chunk} does not divide the sequence "
                         f"length {S}")
    return BH, S, P, N


def smem_plan(chunk: int, N: int, P: int) -> dict:
    """Bytes of dynamic shared memory one block uses at chunk ``chunk`` and
    dims N, P, by part, in the order the parts lie in shared memory
    (``csrc/ssd_scan.cu``, ``plan_of``), with the ``total``. The chunk's
    rows are padded to a multiple of ``TILE``."""
    Qp = -(-chunk // TILE) * TILE
    parts = {"state": N * P, "x": Qp * P, "B transposed": N * (Qp + PAD),
             "C transposed (sub-tile)": N * (TILE + PAD),
             "scores (sub-tile pair)": TILE * TILE,
             "y accumulator": TILE * P, "cumsum, dt, w": 3 * Qp}
    plan = {k: 4 * v for k, v in parts.items()}
    plan["total"] = sum(plan.values())
    return plan


def tc_smem_plan() -> dict:
    """Bytes of dynamic shared memory one block of the bf16 tensor-core
    kernel asks for, by part (``csrc/ssd_scan.cu``, ``kTcSmemBytes``),
    whatever the dims: slack to align to the 1,024-byte swizzle atom; two
    buffers (one chunk's loads run while the block works on another), each
    x, B and C of a chunk as bf16 rows of 64 (128 bytes, swizzled), 256
    rows each; the carried state's three bf16 terms (64 x 64 each; before
    them, the second warpgroup's part of the chunk's own state); cum, w and
    dt of each buffer's chunk; the two tickets; a TMA mbarrier per
    buffer."""
    parts = {"alignment": 1024, "x, B, C (two buffers)": 2 * 3 * 256 * 128,
             "state terms": TC_TERMS * 64 * 128,
             "cumsum, w, dt (two each)": 6 * 256 * 4, "tickets": 8,
             "mbarriers": 16}
    return {**parts, "total": sum(parts.values())}


def tc_scratch(BH: int, S: int, chunk: int, device) -> tuple:
    """The tensor-core kernel's scratch, allocated on the current stream:
    the carried states ``[S / chunk, BH, 64 * 64]`` float32 (written and
    read by the kernel only) and ``S / chunk x BH + 1`` int32 zeros (a flag
    per published state, then the ticket counter)."""
    nc = S // chunk
    return (torch.empty((nc, BH, TC_SLOT), dtype=torch.float32,
                        device=device),
            torch.zeros(nc * BH + 1, dtype=torch.int32, device=device))


def check_smem_fit(chunk: int, N: int, P: int) -> dict:
    """``smem_plan``; raises ``ValueError`` when the dims are outside what the
    kernel takes (chunk in [1, 256], N and P multiples of 4 in [4, 64]) or
    the block would need more than the ``SMEM_LIMIT`` bytes a block may
    use."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"the kernel takes a chunk in [1, {MAX_CHUNK}], got "
                         f"{chunk}")
    for name, d in (("N", N), ("P", P)):
        if d % 4 or not 4 <= d <= MAX_NP:
            raise ValueError(f"the kernel takes {name} a multiple of 4 in "
                             f"[4, {MAX_NP}], got {d}")
    plan = smem_plan(chunk, N, P)
    if plan["total"] > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: {plan['total']:,} B of shared memory "
                         f"per block, over the {SMEM_LIMIT:,} B a block may "
                         f"use")
    return plan


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_tc_smem_bytes.argtypes = []
        lib.ssd_scan_tc_smem_bytes.restype = ctypes.c_int
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, heads: int,
             chunk: int) -> tuple:
    """``(y, state)`` in ONE launch of the CUDA kernel, on
    ``torch.cuda.current_stream()``.

    Raises on tensors the kernel does not take (not on the card, other
    dtypes, a chunk outside [1, 256] or not dividing S, N or P not a
    multiple of 4 in [4, 64], a non-contiguous layout) and on a refused
    launch; it never runs the plain version. In bfloat16 it allocates the
    tensor-core kernel's scratch (``tc_scratch``) and copies an x, Bm or
    Cm whose data is not 8-byte aligned. It has no gradient
    (``kernels.ops.ssd`` refuses a CUDA input that needs one).
    ``ssd_scan.launches`` counts launches."""
    BH, S, P, N = _check(x, dt, A, Bm, Cm, heads, chunk)
    if not x.is_cuda:
        raise ValueError("ssd_scan launches the CUDA kernel and takes CUDA "
                         "tensors; use ssd_scan_plain on the CPU")
    check_smem_fit(chunk, N, P)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # the tensor-core kernel copies 8 bytes at a time
        x, Bm, Cm = (t if t.data_ptr() % 8 == 0 else t.clone()
                     for t in (x, Bm, Cm))
    lib = _bind(build.load("ssd_scan"))
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        state = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
        states, flags = tc_scratch(BH, S, chunk, x.device) if bf16 else \
            (None, None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            states.data_ptr() if bf16 else None,
            flags.data_ptr() if bf16 else None, BH, S, P, N, chunk, heads,
            int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, heads: int,
                   chunk: int) -> tuple:
    """The same function in plain PyTorch, in the TPU kernel's op order
    (``_ssd_kernel``), one chunk of Q steps at a time, all rows at once:
    x, B, C upcast to float32; ``a = dt A`` and its inclusive cumsum
    (accumulated in float64, each prefix rounded once to float32: the
    kernel's sequential sum rounds to the same values); the
    decay ``exp(cum_t - cum_s)`` where s <= t, else 0 (``torch.where``: the
    exponent above the diagonal is positive and may overflow);
    ``((C B^T) * decay * dt_s) x``; plus ``(C S_prev) * exp(cum)``; y
    rounded once to x's type; ``S = exp(a_tot) S_prev + B^T (x * exp(a_tot
    - cum) dt)`` in float32. On the card its float32 products must not run
    in TF32, so it refuses to run when TF32 is on."""
    BH, S, P, N = _check(x, dt, A, Bm, Cm, heads, chunk)
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("ssd_scan_plain needs full float32 products: "
                           "turn TF32 off")
    B, H, Q = BH // heads, heads, chunk
    xv = x.reshape(B, H, S, P)
    dtv = dt.reshape(B, H, S)
    Av = A.reshape(B, H, 1)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xv)
    for c0 in range(0, S, Q):
        xc = xv[:, :, c0:c0 + Q].float()                  # [B, H, Q, P]
        dtc = dtv[:, :, c0:c0 + Q]                        # [B, H, Q]
        Bc = Bm[:, None, c0:c0 + Q].float()               # [B, 1, Q, N]
        Cc = Cm[:, None, c0:c0 + Q].float()
        cum = torch.cumsum((dtc * Av).double(), dim=-1).float()
        dec = torch.where(mask, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
        cb = torch.matmul(Cc, Bc.transpose(-1, -2))       # [B, 1, Q, Q]
        scores = cb * dec * dtc[..., None, :]
        yc = torch.matmul(scores, xc)
        yc = yc + torch.matmul(Cc, state) * torch.exp(cum)[..., None]
        y[:, :, c0:c0 + Q] = yc.to(x.dtype)
        a_tot = cum[..., -1:]                             # [B, H, 1]
        w = torch.exp(a_tot - cum) * dtc
        state = torch.exp(a_tot)[..., None] * state + torch.matmul(
            Bc.transpose(-1, -2), xc * w[..., None])
    return y.view(BH, S, P), state.view(BH, N, P)


def work(BH: int, S: int, P: int, N: int, chunk: int,
         dtype=torch.bfloat16, *, heads: int) -> dict:
    """Operations and device-memory bytes one call must spend, from the
    shapes alone. Per chunk of Q steps: the lower triangle (s <= t) of the
    two [Q, Q] products, ``Q (Q + 1) / 2 (N + P)`` multiply-adds, plus
    ``C S_prev`` and ``B^T (x w)``, ``Q N P`` each; a multiply-add counts 2.
    Bytes: x read and y written in ``dtype``, Bm and Cm (``BH // heads``
    batch rows) read in ``dtype``, dt and A read and the state written in
    float32, each once."""
    Q = chunk
    fma = BH * (S // Q) * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P)
    item = torch.empty((), dtype=dtype).element_size()
    return {"flops": 2 * fma,
            "bytes": item * (2 * BH * S * P + 2 * (BH // heads) * S * N)
            + 4 * (BH * S + BH + BH * N * P)}


def tc_operations(BH: int, S: int, chunk: int) -> int:
    """Operations the bf16 kernel issues on the tensor cores (2 per
    multiply-add of its m64n64k16 products, padding and terms included):
    per chunk, rows zero-filled to a multiple of 64 in ``r`` sub-tiles,
    C B^T (4 products) and scores x (4 x ``TC_TERMS``) for each of the
    ``r (r + 1) / 2`` tile pairs at or left of the diagonal, C S (4 x
    ``TC_TERMS``) per sub-tile and L^T (``TC_TERMS`` per 16 rows)."""
    r = -(-chunk // 64)
    products = (r * (r + 1) // 2 * (4 + 4 * TC_TERMS) + r * 4 * TC_TERMS
                + 4 * r * TC_TERMS)
    return BH * (S // chunk) * products * 2 * 64 * 64 * 16
