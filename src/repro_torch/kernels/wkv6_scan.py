"""Chunked RWKV6 WKV scan: the CUDA kernel's wrapper, its plain PyTorch
version, the work it does and its shared-memory plans.

``wkv6_scan(r, k, v, logw, u, chunk=)`` launches ``csrc/wkv6_scan.cu`` (it
replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6.py:69 wkv6_scan``
of the JAX package): in bfloat16 ``wkv6_scan_tc_kernel``, one block per
(batch-head row, chunk) tile taken by ticket, the chunks of a row in
parallel and only the carried state passed from tile to tile through a
ring of two slots per row, the decays taken per sub-chunk of 16 steps so
that all but the pairs within a sub-chunk become products on the tensor
cores (``wgmma``); in float32 ``wkv6_scan_kernel``, one block per row on
the CUDA cores, the chunks a loop inside the block, the float32 state
resident in shared memory.
``wkv6_scan_plain`` computes the same function with the TPU kernel's op
order, one chunk at a time over all rows at once; it is what a CPU tensor
runs (``kernels.ops.wkv6``) and what the kernel is held against on the
card.

Layouts (the reference's): r, k, v ``[BH, S, c]`` float32 or bfloat16;
logw ``[BH, S, c]`` float32 (<= 0); u ``[BH, c]`` (any float type: both
take it as float32, as the TPU kernel does). Both return ``(y [BH, S, c]``
in r's type``, state [BH, c, c]`` float32``)``, ``state[key][value]``.

Bound (``work``): the operations (the exps counted as one each) over the
card's bf16 tensor rate (989 TFLOP/s) or the bytes over 3.35 TB/s,
whichever is larger (bytes, at rwkv6-3b's forward shape). ``tc_operations``
counts what the bf16 kernel issues on the tensor cores.
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
#: bf16 terms of each float32 operand of the tensor-core kernel's products:
#: the chunk's states (k exp(cum_b - cum), which feed the carried state)
#: take three, which hold it exactly; the products that feed only y take
#: two of each operand
TC_TERMS_STATE = 3
TC_TERMS_Y = 2
#: carried states of a row in the tensor-core kernel's ring, each c x c
#: zero-filled to 64 x 64
TC_RING = 2
TC_SLOT = 64 * 64


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


def tc_smem_plan() -> dict:
    """Bytes of dynamic shared memory one block of the bf16 tensor-core
    kernel asks for, by part (``csrc/wkv6_scan.cu``, ``kTcSmemBytes``),
    whatever the dims: slack to align to the 1,024-byte swizzle atom; r, k
    and v of the chunk as bf16 rows of 64 (128 bytes, swizzled), 64 rows
    each; the chunk's states at the ends of its first three sub-chunks as
    ``TC_TERMS_Y`` bf16 terms each (64 x 64; the first then takes the
    carried state's); cum and cum_prev (64 x 68 floats each); the scores
    within the sub-chunks and the u bonus (64 x 20 floats); the ticket.
    Two blocks fit an SM."""
    parts = {"alignment": 1024, "r, k, v": 3 * 64 * 128,
             "state terms": 3 * TC_TERMS_Y * 64 * 128,
             "cumsum, cum_prev": 2 * 64 * 68 * 4, "scores": 64 * 20 * 4,
             "ticket": 16}
    return {**parts, "total": sum(parts.values())}


def tc_scratch(BH: int, device) -> tuple:
    """The tensor-core kernel's scratch, allocated on the current stream:
    the ring of carried states ``[BH, TC_RING, 64 * 64]`` float32 (written
    and read by the kernel only) and ``BH x TC_RING + 1`` int32 zeros (a
    flag per slot, holding the chunk of the state it was last given plus
    one, then the ticket counter)."""
    return (torch.empty((BH, TC_RING, TC_SLOT), dtype=torch.float32,
                        device=device),
            torch.zeros(BH * TC_RING + 1, dtype=torch.int32, device=device))


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wkv6_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.wkv6_scan_smem_bytes.restype = ctypes.c_int
        lib.wkv6_scan_tc_smem_bytes.argtypes = []
        lib.wkv6_scan_tc_smem_bytes.restype = ctypes.c_int
    return lib


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, *,
              chunk: int = 64) -> tuple:
    """``(y, state)`` in ONE launch of the CUDA kernel, on
    ``torch.cuda.current_stream()``.

    Raises on tensors the kernel does not take (not on the card, other
    dtypes, a chunk outside [1, 64] or not dividing S, c not a multiple of
    4 in [4, 64], a non-contiguous layout) and on a refused launch; it
    never runs the plain version. In bfloat16 it allocates the tensor-core
    kernel's scratch (``tc_scratch``) and copies an r, k or v whose data is
    not 8-byte aligned and a logw not 16-byte aligned. It has no gradient (``kernels.ops.wkv6`` refuses a
    CUDA input that needs one). ``wkv6_scan.launches`` counts launches."""
    BH, S, c = _check(r, k, v, logw, u, chunk)
    if not r.is_cuda:
        raise ValueError("wkv6_scan launches the CUDA kernel and takes CUDA "
                         "tensors; use wkv6_scan_plain on the CPU")
    check_smem_fit(chunk, c)
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bf16 = r.dtype == torch.bfloat16
    if bf16:  # the tensor-core kernel copies 8 and 16 bytes at a time
        r, k, v = (t if t.data_ptr() % 8 == 0 else t.clone()
                   for t in (r, k, v))
        if logw.data_ptr() % 16:
            logw = logw.clone()
    lib = _bind(build.load("wkv6_scan"))
    with torch.cuda.device(r.device):
        u32 = u.float().contiguous()
        y = torch.empty_like(r)
        state = torch.empty((BH, c, c), dtype=torch.float32, device=r.device)
        states, flags = tc_scratch(BH, r.device) if bf16 else (None, None)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u32.data_ptr(), y.data_ptr(), state.data_ptr(),
            states.data_ptr() if bf16 else None,
            flags.data_ptr() if bf16 else None, BH, S, c, chunk, int(bf16),
            stream)
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


def tc_operations(BH: int, S: int, chunk: int) -> int:
    """Operations the bf16 kernel issues on the tensor cores (2 per
    multiply-add of its m64n64k16 products, zero fill and terms included).
    Per chunk of ``g = ceil(Q / 16)`` sub-chunks: each sub-chunk's own part
    of the chunk's state, one 16-step slice of ``TC_TERMS_STATE`` products;
    the scores times v, ``g`` slices of ``TC_TERMS_Y``; r~ S_e, 4 slices of
    the key channels for each of the ``g - 1`` states at sub-chunk ends;
    (r exp(cum_prev)) S_prev, 4 slices, in every chunk but a row's first;
    each of the last two ``TC_TERMS_Y (TC_TERMS_Y + 1) / 2`` products a
    slice (the terms p, q of the two float32 operands with p + q <
    ``TC_TERMS_Y``)."""
    g = -(-chunk // 16)
    pairs = TC_TERMS_Y * (TC_TERMS_Y + 1) // 2
    local = TC_TERMS_STATE * g + TC_TERMS_Y * g + pairs * 4 * (g - 1)
    nc = S // chunk
    return (BH * nc * local + BH * (nc - 1) * pairs * 4) * 2 * 64 * 64 * 16
