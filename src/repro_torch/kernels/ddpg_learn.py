"""The fused DDPG inner loop: the CUDA kernel's wrapper, its plain PyTorch
version, and the work it does.

``ddpg_learn`` launches ``csrc/ddpg_learn.cu`` (one thread block per tuning
session, all U updates inside the block, the session's whole learner state
resident in shared memory for the launch at the offsets of ``smem_plan``;
it replaces the Pallas TPU kernel ``kernels/ddpg_fused.py::ddpg_fused_learn``
of the JAX package).
``ddpg_learn_plain`` computes the same function as a Python loop of
``core.ddpg._ddpg_step`` with autograd, batched over sessions; it is what a
CPU tensor runs (``kernels.ops.ddpg_inner_loop``) and what the kernel is
held against on the card.

Both take a fleet learner state (``DDPGState`` with a leading session axis:
``flat [N, F]``, ``counts [N, 2]`` int32, ``step [N]`` int32) and the
pre-gathered minibatches ``(s, a, r, s2)``, each ``[N, U, B, dim]``
(``r [N, U, B]``), float32 and contiguous. Both update the state IN PLACE
and return the per-update metrics ``[N, U, 3]`` (critic_loss, actor_loss,
q_mean).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGConfig, DDPGState, _ddpg_step, \
    state_layout
from repro_torch.kernels import build
from repro_torch.optim.adam import B1, B2, EPS


def _check(state: DDPGState, batches: tuple, cfg: DDPGConfig) -> tuple:
    """Validate shapes, dtypes, devices and contiguity; return (N, U)."""
    flat, counts, step = state
    s, a, r, s2 = batches
    if len(cfg.hidden) != 2:
        raise ValueError(f"the fused learner takes two hidden layers, got "
                         f"hidden={cfg.hidden!r}")
    floats = state_layout(cfg).floats
    if flat.dim() != 2 or flat.shape[1] != floats:
        raise ValueError(f"state.flat must be [N, {floats}], got "
                         f"{tuple(flat.shape)}")
    n = flat.shape[0]
    if s.dim() != 4:
        raise ValueError(f"s must be [N, U, B, k], got {tuple(s.shape)}")
    u, b = s.shape[1], s.shape[2]
    k, m = cfg.state_dim, cfg.action_dim
    want = {"counts": (counts, (n, 2), torch.int32),
            "step": (step, (n,), torch.int32),
            "s": (s, (n, u, b, k), torch.float32),
            "a": (a, (n, u, b, m), torch.float32),
            "r": (r, (n, u, b), torch.float32),
            "s2": (s2, (n, u, b, k), torch.float32),
            "flat": (flat, (n, floats), torch.float32)}
    if b != cfg.batch_size:
        raise ValueError(f"minibatch rows {b} != cfg.batch_size "
                         f"{cfg.batch_size}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != flat.device:
            raise ValueError(f"{name} is on {t.device}, state on "
                             f"{flat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, u


def _hyper(cfg: DDPGConfig) -> list:
    """The launch's float32 constants, each the rounding of the Python
    expression the reference evaluates."""
    return [np.float32(x) for x in (
        cfg.gamma, cfg.tau, 1 - cfg.tau, B1, 1 - B1, B2, 1 - B2, EPS,
        -cfg.actor_lr, -cfg.critic_lr)]


#: dynamic shared memory one block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the hidden widths the kernels are built for (``csrc/ddpg_update.cuh``)
HIDDEN = (64, 64)


def smem_plan(cfg: DDPGConfig) -> dict:
    """Bytes of dynamic shared memory one block of the learner kernel uses,
    by part, in the order the parts lie in shared memory: the session's
    whole learner state (parameters, targets and both Adam moments, resident
    for the launch) and one update's activations and deltas. The kernel
    takes the scratch's offset from this plan (``launch_args``)."""
    k, m, (h1, h2), b = cfg.state_dim, cfg.action_dim, cfg.hidden, \
        cfg.batch_size
    kc = k + m
    parts = {"learner_state": state_layout(cfg).floats,
             "learner": 2 * b * kc + 4 * b * (h1 + h2) + 2 * b * m + 3 * b
             + 3}
    parts = {name: 4 * floats for name, floats in parts.items()}
    parts["total"] = sum(parts.values())
    return parts


def check_plan(plan: dict, cfg: DDPGConfig, kernel: str,
               also: str = "") -> None:
    """Raise ``ValueError`` when ``plan`` (a kernel's shared-memory plan for
    ``cfg``) exceeds the per-block opt-in limit, naming the knobs to lower,
    or when ``cfg``'s widths are not the ones the kernels are built for."""
    if plan["total"] > SMEM_LIMIT:
        top = sorted(((v, k) for k, v in plan.items() if k != "total"),
                     reverse=True)[:3]
        raise ValueError(
            f"the {kernel} kernel needs {plan['total']:,} B of shared "
            f"memory per block, over the {SMEM_LIMIT:,} B a block may use "
            f"(largest parts: " + ", ".join(f"{k} {v:,} B" for v, k in top)
            + f"); lower {also}the hidden widths or the batch size")
    if tuple(cfg.hidden) != HIDDEN:
        raise ValueError(f"the {kernel} kernel is built for hidden "
                         f"{HIDDEN}, got hidden={tuple(cfg.hidden)!r}")


def check_smem_fit(cfg: DDPGConfig) -> dict:
    """``smem_plan`` of this configuration, checked by ``check_plan``."""
    plan = smem_plan(cfg)
    check_plan(plan, cfg, "ddpg_learn")
    return plan


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The library's two functions: the launcher, and
    ``ddpg_learn_shared_bytes(smem_bytes)``, the shared memory a block of
    the kernel holds once opted into ``smem_bytes``."""
    fn = lib.ddpg_learn_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ddpg_learn_shared_bytes.argtypes = [ctypes.c_int]
        lib.ddpg_learn_shared_bytes.restype = ctypes.c_int
    return lib


def launch_args(state: DDPGState, batches: tuple, metrics: torch.Tensor,
                cfg: DDPGConfig, plan: dict) -> tuple:
    """The arguments of ``ddpg_learn_launch`` but the stream: device
    pointers, the layout and constants as ctypes arrays (pass their
    addresses), the sizes and ``plan``'s total bytes and scratch offset."""
    flat, counts, _ = state
    s, a, r, s2 = batches
    n, u = s.shape[:2]
    layout = state_layout(cfg)
    offsets = (ctypes.c_int * 48)(*layout.flat_offsets())
    hyper = (ctypes.c_float * 10)(*_hyper(cfg))
    return (flat.data_ptr(), counts.data_ptr(), s.data_ptr(), a.data_ptr(),
            r.data_ptr(), s2.data_ptr(), metrics.data_ptr(), offsets, hyper,
            n, u, cfg.batch_size, cfg.state_dim, cfg.action_dim,
            cfg.hidden[0], cfg.hidden[1], layout.floats, plan["total"],
            plan["learner_state"] // 4)


def ddpg_learn(state: DDPGState, batches: tuple, *,
               cfg: DDPGConfig) -> torch.Tensor:
    """Run all U updates of every session in ONE launch of the CUDA
    learner, on ``torch.cuda.current_stream()``.

    Updates ``state`` IN PLACE (``flat``, ``counts``, ``step``), like the
    TPU kernel, which aliases its parameter inputs to its outputs. Returns
    the metrics ``[N, U, 3]``. Raises on a tensor the kernel does not take
    (wrong device, dtype, shape or layout), on a configuration whose
    resident state does not fit a block's shared memory (``smem_plan``) and
    on a refused launch. ``ddpg_learn.launches`` counts launches."""
    n, u = _check(state, batches, cfg)
    plan = check_smem_fit(cfg)
    flat, counts, step = state
    if not flat.is_cuda:
        raise ValueError("ddpg_learn launches the CUDA kernel and takes CUDA "
                         "tensors; use ddpg_learn_plain on the CPU")
    metrics = torch.empty((n, u, 3), dtype=torch.float32, device=flat.device)
    if n == 0 or u == 0:
        return metrics
    lib = _bind(build.load("ddpg_learn"))
    args = launch_args(state, batches, metrics, cfg, plan)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = lib.ddpg_learn_launch(
            *args[:7], *(ctypes.addressof(x) for x in args[7:9]), *args[9:],
            stream)
    if err != 0:
        raise RuntimeError(f"ddpg_learn: kernel launch failed with CUDA "
                           f"error {err}")
    ddpg_learn.launches += 1
    step.add_(u)
    return metrics


ddpg_learn.launches = 0


def ddpg_learn_plain(state: DDPGState, batches: tuple, *,
                     cfg: DDPGConfig) -> torch.Tensor:
    """The same function in plain PyTorch: U ``_ddpg_step``s in a Python
    loop, batched over the N sessions, with autograd. Updates ``state`` IN
    PLACE and returns the metrics ``[N, U, 3]``. On the card its float32
    products must not run in TF32, so it refuses to run when TF32 is on."""
    n, u = _check(state, batches, cfg)
    flat = state.flat
    if flat.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                         torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("ddpg_learn_plain needs full float32 products: "
                           "turn TF32 off")
    s, a, r, s2 = batches
    metrics = torch.empty((n, u, 3), dtype=torch.float32, device=flat.device)
    cur = state
    for i in range(u):
        cur, m = _ddpg_step(cur, (s[:, i], a[:, i], r[:, i], s2[:, i]), cfg)
        metrics[:, i] = torch.stack(
            [m["critic_loss"], m["actor_loss"], m["q_mean"]], dim=-1)
    state.flat.copy_(cur.flat)
    state.counts.copy_(cur.counts)
    state.step.copy_(cur.step)
    return metrics


def work(cfg: DDPGConfig, n: int, u: int) -> dict:
    """Floating-point operations and device-memory bytes one learner call
    must spend on N sessions x U updates, from the shapes alone.

    Operations (a multiply-add counts 2): six MLP forward passes per update
    (target actor, target critic, critic, actor, critic on the policy's
    action, critic for q_mean); the critic's backward (hidden deltas plus
    every weight gradient); the actor's backward through the critic's
    hidden layers to its action inputs, then through the actor; ~15 flops of
    Adam + Polyak per parameter. Bytes: the state and counts read once and
    written once, the minibatches read once, the metrics written once."""
    k, m, (h1, h2), bsz = cfg.state_dim, cfg.action_dim, cfg.hidden, \
        cfg.batch_size

    def gemm(sizes):
        return sum(2 * bsz * fi * fo for fi, fo in zip(sizes[:-1], sizes[1:]))

    actor, critic = gemm(cfg.actor_sizes), gemm(cfg.critic_sizes)
    critic_deltas = 2 * bsz * (h2 + h1 * h2)
    to_action = 2 * bsz * (h2 + h1 * h2 + m * h1)
    actor_deltas = 2 * bsz * (h2 * m + h1 * h2)
    params = sum(fi * fo + fo for sizes in (cfg.actor_sizes, cfg.critic_sizes)
                 for fi, fo in zip(sizes[:-1], sizes[1:]))
    per_update = (2 * actor + 4 * critic + critic_deltas + critic
                  + to_action + actor_deltas + actor + 15 * params)
    floats = state_layout(cfg).floats
    state_bytes = 4 * (floats + 2)
    batch_bytes = 4 * u * bsz * (2 * k + m + 1)
    return {"flops": n * u * per_update,
            "bytes": n * (2 * state_bytes + batch_bytes + 4 * u * 3)}
