"""Chunked RWKV6 WKV scan: the CUDA kernel's wrapper, its plain PyTorch
version, the work it does and its shared-memory plan.

``wkv6_scan(r, k, v, logw, u, chunk=)`` launches ``csrc/wkv6_scan.cu`` (one
thread block per batch-head row, the chunks a loop inside the block, the
float32 state resident in shared memory; it replaces the Pallas TPU kernel
``src/repro/kernels/rwkv6.py:69 wkv6_scan`` of the JAX package).
``wkv6_scan_plain`` computes the same function with the TPU kernel's op
order, one chunk at a time over all rows at once; it is what a CPU tensor
runs (``kernels.ops.wkv6``) and what the kernel is held against on the
card.

Layouts (the reference's): r, k, v ``[BH, S, c]`` float32 or bfloat16;
logw ``[BH, S, c]`` float32 (<= 0); u ``[BH, c]`` (any float type: both
take it as float32, as the TPU kernel does). Both return ``(y [BH, S, c]``
in r's type``, state [BH, c, c]`` float32``)``, ``state[key][value]``.

Bound (``work``): the operations (the exps counted as one each) over the
card's float32 rate (67 TFLOP/s) or the bytes over 3.35 TB/s, whichever is
larger: the decayed scores depend on t, s and the channel, so they are no
matrix product and take the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK = 64
#: the largest head size c (a multiple of 4)
MAX_C = 64
#: padding (floats) of the kernel's transposed [c][Q] rows
PAD = 8
SMEM_LIMIT = 232_448
DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, logw, u, chunk: int) -> tuple:
    """Validate ranks, shapes, dtypes, devices and the chunk; return
    ``(BH, S, c)``."""
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"r, k, v, logw must be [BH, S, c] and u [BH, c], "
                         f"got {tuple(r.shape)}, {tuple(u.shape)}")
    BH, S, c = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r, k, v, logw must be [BH, S, c] alike, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    if tuple(u.shape) != (BH, c):
        raise ValueError(f"u must be [{BH}, {c}], got {tuple(u.shape)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one of {DTYPES}, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or not u.is_floating_point():
        raise ValueError(f"logw must be float32 and u floating, got "
                         f"{logw.dtype}, {u.dtype}")
    if any(t.device != r.device for t in (k, v, logw, u)):
        raise ValueError("r, k, v, logw, u must lie on one device")
    if chunk < 1 or S % chunk:
        raise ValueError(f"the chunk {chunk} does not divide the sequence "
                         f"length {S}")
    return BH, S, c


def smem_plan(chunk: int, c: int) -> dict:
    """Bytes of dynamic shared memory one block uses at chunk ``chunk`` and
    head size ``c``, by part, in the order the parts lie in shared memory
    (``csrc/wkv6_scan.cu``, ``plan_of``), with the ``total``. The chunk's
    steps are padded to a multiple of 4."""
    Qp = -(-chunk // 4) * 4
    ld = Qp + PAD
    parts = {"state": c * c, "r transposed": c * ld,
             "k transposed": c * ld, "cumsum transposed": c * ld,
             "cum_prev transposed": c * ld, "v": Qp * c, "scores": Qp * Qp,
             "u bonus": Qp, "u": c}
    plan = {k: 4 * v for k, v in parts.items()}
    plan["total"] = sum(plan.values())
    return plan


def check_smem_fit(chunk: int, c: int) -> dict:
    """``smem_plan``; raises ``ValueError`` when the dims are outside what the
    kernel takes (chunk in [1, 64], c a multiple of 4 in [4, 64]) or the
    block would need more than the ``SMEM_LIMIT`` bytes a block may use."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"the kernel takes a chunk in [1, {MAX_CHUNK}], got "
                         f"{chunk}")
    if c % 4 or not 4 <= c <= MAX_C:
        raise ValueError(f"the kernel takes c a multiple of 4 in [4, "
                         f"{MAX_C}], got {c}")
    plan = smem_plan(chunk, c)
    if plan["total"] > SMEM_LIMIT:
        raise ValueError(f"wkv6_scan: {plan['total']:,} B of shared memory "
                         f"per block, over the {SMEM_LIMIT:,} B a block may "
                         f"use")
    return plan


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.wkv6_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wkv6_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.wkv6_scan_smem_bytes.restype = ctypes.c_int
    return lib


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 64) -> tuple:
    """``(y, state)`` in ONE launch of the CUDA kernel, on
    ``torch.cuda.current_stream()``.

    Raises on tensors the kernel does not take (not on the card, other
    dtypes, a chunk outside [1, 64] or not dividing S, c not a multiple of
    4 in [4, 64], a non-contiguous layout) and on a refused launch; it
    never runs the plain version. It has no gradient (``kernels.ops.wkv6``
    refuses a CUDA input that needs one). ``wkv6_scan.launches`` counts
    launches."""
    BH, S, c = _check(r, k, v, logw, u, chunk)
    if not r.is_cuda:
        raise ValueError("wkv6_scan launches the CUDA kernel and takes CUDA "
                         "tensors; use wkv6_scan_plain on the CPU")
    check_smem_fit(chunk, c)
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    u32 = u.float().contiguous()
    y = torch.empty_like(r)
    state = torch.empty((BH, c, c), dtype=torch.float32, device=r.device)
    lib = _bind(build.load("wkv6_scan"))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u32.data_ptr(), y.data_ptr(), state.data_ptr(), BH, S, c, chunk,
            int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"wkv6_scan: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6_scan.launches += 1
    return y, state


wkv6_scan.launches = 0


def cumsum_rounded(lw: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive cumsum of float32 ``lw`` along ``dim``, in order: each
    step's sum taken in float64 and the running sum rounded to float32, as
    the kernel sums. (Rounding the running sum, and not only each prefix,
    keeps ``cum - lw`` equal to the previous prefix in most steps, so the
    decays between near steps come out nearly exact.)"""
    out = torch.empty_like(lw)
    run = torch.zeros_like(lw.select(dim, 0))
    for s in range(lw.shape[dim]):
        run = (run.double() + lw.select(dim, s).double()).float()
        out.select(dim, s).copy_(run)
    return out


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor, *,
                    chunk: int = 64) -> tuple:
    """The same function in plain PyTorch, in the TPU kernel's op order
    (``_wkv_kernel``), one chunk of Q steps at a time, all rows at once:
    r, k, v, u upcast to float32; the inclusive cumsum of logw
    (``cumsum_rounded``, as the kernel sums) and ``cum_prev = cum -
    logw``; the decay ``exp(min(cum_prev_t - cum_s, 0))`` where s < t,
    else 0 (``torch.where``); scores ``sum_c (r_t decay) k_s``; ``y =
    scores v + (sum_c r u k) v + (r exp(cum_prev)) S_prev`` rounded once to
    r's type; ``S = exp(cum_tot) S_prev + (k exp(cum_tot - cum))^T v`` in
    float32. The chunk's [Q, Q, c] decay tensor is built (here a chunk of
    all rows at once). On the card its float32 products must not run in
    TF32, so it refuses to run when TF32 is on."""
    BH, S, c = _check(r, k, v, logw, u, chunk)
    if r.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("wkv6_scan_plain needs full float32 products: "
                           "turn TF32 off")
    Q = chunk
    strict = torch.ones((Q, Q), dtype=torch.bool,
                        device=r.device).tril(-1)[:, :, None]
    u32 = u.float()[:, None, :]                           # [BH, 1, c]
    state = torch.zeros((BH, c, c), dtype=torch.float32, device=r.device)
    y = torch.empty_like(r)
    for c0 in range(0, S, Q):
        rc, kc, vc = (t[:, c0:c0 + Q].float() for t in (r, k, v))
        lw = logw[:, c0:c0 + Q]
        cum = cumsum_rounded(lw, dim=1)                   # [BH, Q, c]
        cum_prev = cum - lw
        dec = torch.where(strict, torch.exp(torch.clamp(
            cum_prev[:, :, None, :] - cum[:, None, :, :], max=0.0)), 0.0)
        scores = (rc[:, :, None, :] * dec * kc[:, None, :, :]).sum(-1)
        diag = (rc * u32 * kc).sum(-1)                    # [BH, Q]
        yc = torch.matmul(scores, vc) + diag[..., None] * vc
        yc = yc + torch.matmul(rc * torch.exp(cum_prev), state)
        y[:, c0:c0 + Q] = yc.to(r.dtype)
        cum_tot = cum[:, -1:, :]                          # [BH, 1, c]
        kd = kc * torch.exp(cum_tot - cum)
        state = torch.exp(cum_tot).transpose(1, 2) * state + torch.matmul(
            kd.transpose(1, 2), vc)
    return y, state


def work(BH: int, S: int, c: int, chunk: int,
         dtype=torch.bfloat16) -> dict:
    """Operations and device-memory bytes one call must spend, from the
    shapes alone. Per chunk of Q steps, over the P = Q (Q - 1) / 2 pairs
    s < t: the decayed scores, per pair and channel one exp, a
    subtraction, a product and a multiply-add; ``scores v``, P c
    multiply-adds; ``(r exp(cum_prev)) S_prev`` and ``kd^T v``, Q c^2 each;
    the u bonus (3 Q c), its product with v (2 Q c), the two decayed tiles
    (Q c exps, 3 Q c) and the state's decay (c exps, 2 c^2). A multiply-add
    counts 2, an exp 1 (``exps`` counts them apart too). Bytes: r, k, v read
    and y written in ``dtype``, logw read, u read and the state written in
    float32, each once."""
    Q, n = chunk, BH * (S // chunk)
    P = Q * (Q - 1) // 2
    exps = n * (P * c + Q * c + c)
    flops = n * (P * c * 4 + P * c * 2 + 2 * 2 * Q * c * c + 5 * Q * c
                 + 3 * Q * c + 2 * c * c) + exps
    item = torch.empty((), dtype=dtype).element_size()
    return {"flops": flops, "exps": exps,
            "bytes": item * 4 * BH * S * c + 4 * (BH * S * c + BH * c
                                                  + BH * c * c)}
