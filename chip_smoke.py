#!/usr/bin/env python3
"""Drive the PyTorch port of the Magpie tuner on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. Phases, one JSON line each:

  1. device   the card's name and count, and ``nvidia-smi``'s name and power
              limit;
  2. build    every CUDA source of ``src/repro_torch/kernels/csrc`` compiled
              (one ``nvcc`` per source, all started together);
  3. check    the ``ddpg_learn`` kernel against its plain PyTorch version at
              N = 1 and N = 1024 sessions on the 2-D and 8-D spaces, from
              independent ``ddpg_init`` states and minibatches gathered from
              a 64-row replay: Adam counts and steps exact, the median and
              90th-percentile session errors within ``RTOL`` and
              ``RTOL_P90``, and two launches on the same inputs bitwise
              equal;
  4. tune     the main path, ``Tuner(engine="host")``, 30 steps on
              ``LustreSimEnv("seq_write")`` (2-D) and on ``LustreSimV2``
              (8-D), with the kernel's launch count read around each run; the
              first steps are replayed on the CPU through the plain learner
              and must make the same decisions;
  5. timing   CUDA-event medians of the kernel and the plain version at
              N = 1 and N = 1024, beside the bound from the shapes.

Then the ``{"kernels": [...]}`` line, ``nvidia-smi``'s line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
It exits non-zero, printing no result, where no CUDA device exists or where
the repository's ``src/repro_torch`` is not beside it.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: kernel vs plain version, per session: the largest max|kernel - plain| /
#: max|plain| over its float tensors. The median session must stay within
#: RTOL and the 90th percentile within RTOL_P90. A few sessions diverge far
#: more: a ReLU input or an Adam gradient within rounding of 0 flips sign,
#: which the JAX package and the port's plain version show between each
#: other on the CPU too (PERF.md, "Parity bounds").
RTOL = 1e-5
RTOL_P90 = 1e-4
#: published H100 SXM peaks (FP32 FLOP/s, HBM3 bytes/s)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SEED_SESSIONS = 1024
UPDATES = 96
CAPACITY = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def fleet_inputs(cfg, n: int, seed: int, device):
    """N independent learners (``ddpg_init`` of keys seed..seed+N-1) and the
    [N, U, B, .] minibatches of a 64-row replay per session."""
    import numpy as np
    import torch

    from repro_torch import random as jrandom
    from repro_torch.core.ddpg import DDPGState, ddpg_init

    states = [ddpg_init(jrandom.PRNGKey(seed + i), cfg, "cpu")
              for i in range(n)]
    state = DDPGState(*(torch.stack(xs).to(device) for xs in zip(*states)))
    rng = np.random.default_rng(seed)
    k, m = cfg.state_dim, cfg.action_dim
    replay = [rng.random((n, CAPACITY, k)), rng.random((n, CAPACITY, m)),
              rng.standard_normal((n, CAPACITY)), rng.random((n, CAPACITY, k))]
    idx = torch.as_tensor(rng.integers(0, CAPACITY, (n, UPDATES,
                                                     cfg.batch_size)))
    rows = torch.arange(n)[:, None, None]
    batches = tuple(
        torch.as_tensor(x, dtype=torch.float32)[rows, idx].contiguous()
        .to(device) for x in replay)
    return state, batches


def clone_state(state):
    from repro_torch.core.ddpg import DDPGState
    return DDPGState(*(t.clone() for t in state))


def compare(state, metrics, ref_state, ref_metrics, cfg) -> dict:
    """Counts and steps must be equal. Per session, the error is the largest
    ``max|a - b| / max|b|`` over its float tensors (each w/b of the eight
    parameter sets, and each metric column); returns the quantiles of that
    error over sessions and the largest absolute difference."""
    import torch

    from repro_torch.core.ddpg import unflatten

    if not torch.equal(state.counts, ref_state.counts):
        raise AssertionError("Adam counts differ from the plain version")
    if not torch.equal(state.step, ref_state.step):
        raise AssertionError("learner steps differ from the plain version")
    if not (bool(torch.isfinite(state.flat).all())
            and bool(torch.isfinite(metrics).all())):
        raise AssertionError("kernel produced a non-finite value")
    got, want = unflatten(state.flat, cfg), unflatten(ref_state.flat, cfg)
    pairs = [(g[key], w[key]) for name in got
             for g, w in zip(got[name], want[name]) for key in ("w", "b")]
    pairs += [(metrics[..., j], ref_metrics[..., j]) for j in range(3)]
    n = state.flat.shape[0]
    rel = torch.zeros(n, dtype=torch.float64, device=state.flat.device)
    abs_err = 0.0
    for g, w in pairs:
        diff = (g - w).abs().reshape(n, -1).amax(dim=1).double()
        scale = w.abs().reshape(n, -1).amax(dim=1).double().clamp_min(1e-30)
        rel = torch.maximum(rel, diff / scale)
        abs_err = max(abs_err, float(diff.max()))
    q = torch.quantile(rel, torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64,
                                         device=rel.device)).tolist()
    return {"max_abs_err": abs_err, "median_rel_err": q[0],
            "p90_rel_err": q[1], "max_rel_err": q[2]}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_check(configs) -> dict:
    import torch

    from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain

    worst = {"max_abs_err": 0.0, "median_rel_err": 0.0, "p90_rel_err": 0.0,
             "max_rel_err": 0.0}
    for name, cfg in configs.items():
        for n in (1, SEED_SESSIONS):
            state, batches = fleet_inputs(cfg, n, seed=100, device="cuda")
            k1, k2, p = clone_state(state), clone_state(state), \
                clone_state(state)
            m1 = ddpg_learn(k1, batches, cfg=cfg)
            m2 = ddpg_learn(k2, batches, cfg=cfg)
            mp = ddpg_learn_plain(p, batches, cfg=cfg)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2)) and \
                torch.equal(m1, m2)
            if not bitwise:
                raise AssertionError("two launches on the same inputs differ")
            err = compare(k1, m1, p, mp, cfg)
            emit({"phase": "check", "space": name, "sessions": n,
                  "bitwise_repeat": bitwise, "rtol": RTOL,
                  "rtol_p90": RTOL_P90, **err})
            if err["median_rel_err"] > RTOL or err["p90_rel_err"] > RTOL_P90:
                raise AssertionError(
                    f"kernel vs plain: session errors median "
                    f"{err['median_rel_err']} (bound {RTOL}), p90 "
                    f"{err['p90_rel_err']} (bound {RTOL_P90}) ({name}, "
                    f"N={n})")
            for key in worst:
                worst[key] = max(worst[key], err[key])
    return worst


def phase_tune(space: str, steps: int) -> dict:
    from repro_torch.core import Scalarizer, Tuner
    from repro_torch.envs import LustreSimEnv, LustreSimV2
    from repro_torch.kernels.ddpg_learn import ddpg_learn

    env_cls = LustreSimEnv if space == "2d" else LustreSimV2

    def tuner(device):
        env = env_cls("seq_write", seed=0)
        scal = Scalarizer(weights={"throughput": 1.0}, specs=env.metric_specs)
        return Tuner(env, scal, seed=0, device=device)

    gpu = tuner(None)
    learn_calls = 0
    agent_learn = gpu.agent.learn

    def counted_learn(*args, **kwargs):
        nonlocal learn_calls
        learn_calls += 1
        return agent_learn(*args, **kwargs)

    gpu.agent.learn = counted_learn
    ddpg_learn.launches = 0
    t0 = time.perf_counter()
    result = gpu.run(steps)
    wall = time.perf_counter() - t0
    launches = ddpg_learn.launches
    if launches != learn_calls or launches == 0:
        raise AssertionError(f"{space}: kernel launched {launches} times for "
                             f"{learn_calls} learn calls")
    for rec in result.history:
        if not all(math.isfinite(v) for v in rec.metrics.values()):
            raise AssertionError(f"{space}: non-finite metrics")
    gain = result.gain("throughput")
    if not math.isfinite(gain) or gain <= 0:
        raise AssertionError(f"{space}: tuning did not improve throughput "
                             f"({gain})")
    # reference on a small input: the same seeds on the CPU (plain learner)
    replay_steps = 10
    cpu = tuner("cpu").run(replay_steps)
    if cpu.default_metrics != result.default_metrics:
        raise AssertionError(f"{space}: default metrics differ from the CPU")
    gpu_cfgs = [h.config for h in result.history[:replay_steps]]
    cpu_cfgs = [h.config for h in cpu.history]
    if gpu_cfgs[:8] != cpu_cfgs[:8]:
        raise AssertionError(f"{space}: warmup decisions differ from the CPU")
    same = next((i for i, (a, b) in enumerate(zip(gpu_cfgs, cpu_cfgs))
                 if a != b), replay_steps)
    learn_s = [h.learn_seconds for h in result.history]
    step_s = [h.action_seconds + h.learn_seconds for h in result.history]
    out = {"phase": "tune", "space": space, "steps": steps,
           "kernel_launches": launches, "learn_calls": learn_calls,
           "default_throughput": result.default_metrics["throughput"],
           "tuned_throughput": result.best_metrics["throughput"],
           "gain": gain, "best_config": result.best_config,
           "wall_seconds": wall,
           "median_step_seconds": statistics.median(step_s),
           "median_learn_seconds": statistics.median(learn_s),
           "cpu_replay_steps": replay_steps,
           "configs_equal_to_cpu_through_step": same,
           "warmup_equal_to_cpu": True}
    emit(out)
    return out


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(configs, smi: str) -> list:
    from repro_torch.kernels.ddpg_learn import ddpg_learn, ddpg_learn_plain, \
        work

    rows = []
    for name, cfg in configs.items():
        for n in (1, SEED_SESSIONS):
            state, batches = fleet_inputs(cfg, n, seed=200, device="cuda")
            ks, ps = clone_state(state), clone_state(state)
            before = ddpg_learn.launches
            kernel_ms = time_ms(lambda: ddpg_learn(ks, batches, cfg=cfg), 20)
            ddpg_learn.launches = before  # timing launches are not counted
            plain_ms = time_ms(
                lambda: ddpg_learn_plain(ps, batches, cfg=cfg), 20, warmup=1)
            w = work(cfg, n, UPDATES)
            flops_ms = w["flops"] / PEAK_F32_FLOPS * 1e3
            bytes_ms = w["bytes"] / PEAK_BYTES * 1e3
            row = {"phase": "timing", "space": name, "sessions": n,
                   "updates": UPDATES, "ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": max(flops_ms, bytes_ms),
                   "bound_by": "operations" if flops_ms >= bytes_ms
                   else "bytes",
                   "flops": w["flops"], "bytes": w["bytes"],
                   "bound_share": max(flops_ms, bytes_ms) / kernel_ms,
                   "library_ms": None, "card": smi}
            emit(row)
            rows.append(row)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = build.build_all()
    for name, entry in log.items():
        print(f"[{name}] nvcc -Xptxas -v:\n{entry['ptxas']}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in log.items()}})

    configs = {"2d": DDPGConfig(state_dim=12, action_dim=2),
               "8d": DDPGConfig(state_dim=12, action_dim=8)}
    err = phase_check(configs)
    tunes = [phase_tune("2d", 30), phase_tune("8d", 30)]
    rows = phase_timing(configs, smi)

    main_row = next(r for r in rows
                    if r["space"] == "2d" and r["sessions"] == SEED_SESSIONS)
    emit({"kernels": [{
        "name": "ddpg_learn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ddpg_learn.cu",
        "replaces": "src/repro/kernels/ddpg_fused.py:316",
        "launches": sum(t["kernel_launches"] for t in tunes),
        "max_abs_err": err["max_abs_err"],
        "median_rel_err": err["median_rel_err"],
        "p90_rel_err": err["p90_rel_err"], "max_rel_err": err["max_rel_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "sessions": SEED_SESSIONS, "ok": True}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
