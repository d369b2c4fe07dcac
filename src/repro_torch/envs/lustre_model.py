"""The Lustre environment as pure torch functions (the episode engine's env
core), the twin of the reference's ``envs/lustre_model.py``.

``LustreSimModel`` has the calibrated response surface, client-knob
factors, Table-I metric coupling, cache-warmth AR(1) process and lognormal
noise model of ``envs.lustre_sim``, as float32 tensor functions over a
threefry key chain instead of numpy over a ``np.random.Generator``. One
step is split in two:

  * ``step_draws(key, n_samples)`` (and ``episode_draws`` for T steps)
    walks the key chain and returns the step's draws. The chain splits six
    ways per step whatever the action, so every draw of an episode can be
    made before the episode runs. Per step, in this order (``DRAW_*``):
    ``k_w`` uniform, ``k_run`` normal, ``k_samp`` n normals, ``k_restart``
    uniform in [12, 20), and the ten metric keys ``ks[0..9]`` n normals
    each: 3 + 11 n values, 135 at the default 120 s run / 10 s samples.
  * the step math (``build_lustre_fns``' ``step_fn``) over the state, the
    unit action and those draws.

The torch step (the CPU path, ``ModelEnv.apply`` and the episode kernel's
plain version) and the CUDA kernel's device function
(``kernels/csrc/episode_learn.cu``) read the same draws, so they share one
definition of the randomness. Every function takes leading batch axes:
``params`` fields ``[...]``, ``warmth [...]``, ``last_values [..., m]``,
``action [..., m]``, ``draws [..., 3 + 11 n]``; metrics come out
``[..., 12]`` in ``LUSTRE_STATE_METRICS`` order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jrandom
from repro_torch.core.action_mapping import ParamSpace, coord_maps
from repro_torch.envs.base import EnvModel
from repro_torch.envs.lustre_sim import (
    HDD_MBPS,
    L_DEFAULT,
    NET_CAP,
    paper_param_space,
)
from repro_torch.envs.metrics import LUSTRE_STATE_METRICS, MiB, \
    lustre_metric_specs
from repro_torch.envs.workloads import WORKLOADS, Workload

#: offsets of one step's draws: k_w, k_run, k_samp [n], k_restart, ks [10, n]
DRAW_W, DRAW_RUN, DRAW_SAMP = 0, 1, 2


def draw_restart(n_samples: int) -> int:
    return DRAW_SAMP + n_samples


def draw_metrics(n_samples: int) -> int:
    return DRAW_SAMP + n_samples + 1


def draws_per_step(n_samples: int) -> int:
    return 3 + 11 * n_samples


class LustreParams(NamedTuple):
    """Per-session workload shape parameters (float32 tensors)."""

    base_mbps: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    l_opt: torch.Tensor
    l_width: torch.Tensor
    s_amp: torch.Tensor
    io_kib: torch.Tensor
    write_frac: torch.Tensor
    meta_rate: torch.Tensor
    cache_base: torch.Tensor
    noise_sigma: torch.Tensor
    l_gate: torch.Tensor
    gate_width: torch.Tensor
    cache_kappa: torch.Tensor

    @classmethod
    def from_workload(cls, w: Workload, device=None) -> "LustreParams":
        return cls(*(torch.tensor(np.float32(getattr(w, f)), device=device)
                     for f in cls._fields))

    @classmethod
    def from_vector(cls, vec: torch.Tensor) -> "LustreParams":
        """From ``[..., 14]`` (the kernel's layout)."""
        return cls(*vec.unbind(-1))

    def vector(self) -> torch.Tensor:
        """``[..., 14]`` float32, fields in order (the kernel's layout)."""
        return torch.stack(list(self), dim=-1)


class LustreEnvState(NamedTuple):
    """Carried env state: the key chain (``[..., 2]`` int64 words), the
    latent cache warmth, and the decoded values of the last applied
    configuration (NaN before the first apply, so the first apply always
    counts as a change)."""

    key: torch.Tensor
    warmth: torch.Tensor
    last_values: torch.Tensor


def episode_draws(key: torch.Tensor, steps: int, n_samples: int) -> tuple:
    """Walk the env key chain ``steps`` steps from ``key [..., 2]``: returns
    the key after the last step and the draws ``[..., steps, 3 + 11 n]``.
    Runs on the key's device; the chain walk is ``steps`` small hashes, the
    draws a handful of batched ones."""
    subkeys = []
    for _ in range(steps):
        ks = jrandom.split_keys(key, 6)  # key, k_w, k_run, k_samp, k_rst, k_m
        key = ks[..., 0, :]
        subkeys.append(ks)
    ks = torch.stack(subkeys, dim=-3)  # [..., T, 6, 2]
    u_w = jrandom.uniform_keys(ks[..., 1, :])
    z_run = jrandom.normal_keys(ks[..., 2, :])
    z_samp = jrandom.normal_keys(ks[..., 3, :], (n_samples,))
    u_rst = jrandom.uniform_keys(ks[..., 4, :], (), 12.0, 20.0)
    km = jrandom.split_keys(ks[..., 5, :], 10)
    z_met = jrandom.normal_keys(km, (n_samples,))  # [..., T, 10, n]
    draws = torch.cat([u_w[..., None], z_run[..., None], z_samp,
                       u_rst[..., None], z_met.flatten(-2)], dim=-1)
    return key, draws


def step_draws(key: torch.Tensor, n_samples: int) -> tuple:
    """One step of ``episode_draws``: (next key, draws ``[..., 3 + 11 n]``)."""
    key, draws = episode_draws(key, 1, n_samples)
    return key, draws[..., 0, :]


@functools.lru_cache(maxsize=None)
def build_lustre_fns(space: ParamSpace, dfs_scope: tuple,
                     run_seconds: float, sample_period: float) -> tuple:
    """(init_fn, step_fn, perf_fn) for one parameter space.

    ``step_fn(params, state, action, draws, eval_run) -> (state, metrics,
    cost)`` returns the state with the same key: the chain is advanced by
    whoever made ``draws`` (``step_draws``)."""
    maps = coord_maps(space)
    names = space.names
    m = space.dim
    pos = {n: j for j, n in enumerate(names)}
    if "stripe_count" not in pos or "stripe_size" not in pos:
        raise ValueError("Lustre model needs stripe_count and stripe_size")
    dfs_mask = [n in dfs_scope for n in names]
    n_samples = max(2, int(run_seconds / sample_period))
    f32 = torch.float32

    def init_fn(params, key):
        del params
        return LustreEnvState(
            key=key, warmth=torch.tensor(0.5, dtype=f32, device=key.device),
            last_values=torch.full((m,), float("nan"), dtype=f32,
                                   device=key.device))

    def mean_perf(p, d):
        """Noise-free surface for one decoded config (the torch twin of
        ``lustre_sim.batch_mean_performance``)."""
        dev = p.base_mbps.device

        def c(x):
            return torch.tensor(np.float32(x), dtype=f32, device=dev)

        sc = d[pos["stripe_count"]]["value"]
        l = d[pos["stripe_size"]]["log2"] - 16.0  # log2(bytes / 64 KiB)

        par = sc ** p.gamma * torch.exp(-p.beta * (sc - 1.0))
        r_gate = 1.0 / (1.0 + torch.exp(-(l - p.l_gate) / p.gate_width))
        p_eff = torch.where(par >= 1.0, 1.0 + (par - 1.0) * r_gate, par)

        def s_raw(ll):
            return 1.0 + p.s_amp * (1.0 - ((ll - p.l_opt) / p.l_width) ** 2)

        s = torch.maximum(c(0.4), s_raw(l)) / \
            torch.maximum(c(0.4), s_raw(c(L_DEFAULT)))
        x = torch.maximum(
            c(0.6), 1.0 - 0.03 * torch.maximum(c(0.0), sc - 1.0)
            * torch.maximum(c(0.0), l - 8.0))
        t = p.base_mbps * p_eff * s * x

        if "service_threads" in pos:
            lg_th = d[pos["service_threads"]]["log2"]
            t = t * (0.75 + 0.33 * torch.exp(-((lg_th - 7.0) / 3.0) ** 2))
        if "max_rpcs_in_flight" in pos:
            rif = d[pos["max_rpcs_in_flight"]]["value"]
            lg_rif = d[pos["max_rpcs_in_flight"]]["log2"]
            per_ost = rif / torch.maximum(sc, c(1.0))
            conc = per_ost / (per_ost + 2.0)
            over = 1.0 - 0.03 * p.meta_rate * torch.maximum(c(0.0),
                                                            lg_rif - 5.0)
            t = t * conc / c(8.0 / 10.0) * torch.maximum(over, c(0.7))
        if "max_pages_per_rpc" in pos:
            lg_pg = d[pos["max_pages_per_rpc"]]["log2"]
            lr_opt = torch.clamp(p.l_opt, 0.0, 4.0)

            def rpc_resp(lr):
                return 1.0 + 0.10 * (1.0 - ((lr - lr_opt) / 4.0) ** 2)

            t = t * rpc_resp(torch.minimum(lg_pg - 4.0, l)) \
                / rpc_resp(torch.minimum(c(4.0), l))
        if "max_dirty_mb" in pos:
            dirty = d[pos["max_dirty_mb"]]["value"]
            lg_dirty = d[pos["max_dirty_mb"]]["log2"]
            h = 1.0 - torch.exp(-dirty / 24.0)
            h0 = c(1.0 - np.exp(-32.0 / 24.0))
            burst = 1.0 - 0.02 * torch.maximum(c(0.0), lg_dirty - 9.0)
            t = t * ((1.0 - p.write_frac) + p.write_frac * h / h0) * burst
        if "read_ahead_mb" in pos:
            ra = d[pos["read_ahead_mb"]]["value"]
            lg_ra = d[pos["read_ahead_mb"]]["log2"]
            seq = torch.clamp(torch.log2(p.io_kib / 8.0) / 7.0, 0.0, 1.0)
            rf = 1.0 - p.write_frac
            h = 1.0 - torch.exp(-ra / 48.0)
            h0 = c(1.0 - np.exp(-64.0 / 48.0))
            gain = 0.25 * rf * seq * (h / h0 - 1.0)
            waste = 0.12 * rf * (1.0 - seq) * torch.clamp(
                (lg_ra - 6.0) / 4.0, 0.0, 1.0)
            t = t * (1.0 + gain - waste)
        if "checksums" in pos:
            ck_on = d[pos["checksums"]]["value"] >= 0.5
            t = t * torch.where(ck_on, c(1.0), 1.04 + 0.06 * p.write_frac)

        t = torch.minimum(torch.minimum(t, c(NET_CAP * 0.95)),
                          sc * HDD_MBPS * 1.05)
        amp = 1.0 + 0.6 * torch.maximum(c(0.0), L_DEFAULT - l) / L_DEFAULT
        iops = t * 1024.0 / p.io_kib * amp
        return {"throughput": t, "iops": iops, "util": t / NET_CAP,
                "l": l, "sc": sc}

    def decode(action):
        a = torch.clamp(action.to(f32), 0.0, 1.0)
        return [maps[j](a[..., j]) for j in range(m)]

    def perf_fn(params, action):
        """Noise-free surface for unit actions ``[..., m]``."""
        return mean_perf(params, decode(action))

    def step_fn(params, state, action, draws, eval_run):
        p = params
        dev = draws.device

        def c(x):
            return torch.tensor(np.float32(x), dtype=f32, device=dev)

        d = decode(action)
        values = torch.stack([dj["value"] for dj in d], dim=-1)
        changed = values != state.last_values  # NaN != v on the first apply
        changed_any = changed.any(dim=-1)
        dfs_changed = (changed & torch.tensor(dfs_mask, device=dev)).any(-1)

        u_w = draws[..., DRAW_W]
        z_run = draws[..., DRAW_RUN]
        z_samp = draws[..., DRAW_SAMP:DRAW_SAMP + n_samples]
        u_rst = draws[..., draw_restart(n_samples)]
        z_met = draws[..., draw_metrics(n_samples):].unflatten(
            -1, (10, n_samples))

        # latent cache warmth: a layout change flushes caches; AR(1)
        warmth = torch.where(changed_any, state.warmth * 0.4, state.warmth)
        # the reference's compiled step rounds this once: fma(0.6, w, 0.4 u)
        warmth = jrandom._fma_f32(c(0.6).expand_as(warmth), warmth,
                                  0.4 * u_w)
        warmth_eff = torch.full_like(warmth, 0.5) if eval_run else warmth

        perf = mean_perf(p, d)
        t, iops, util = perf["throughput"], perf["iops"], perf["util"]
        l, sc = perf["l"], perf["sc"]

        run_len = 1800.0 if eval_run else run_seconds
        cache_factor = torch.exp(p.cache_kappa * (warmth_eff - 0.5))
        het = 1.4 - 0.8 * torch.minimum(c(1.0), util)
        sigma = p.noise_sigma * het * c(np.sqrt(run_seconds / run_len))
        run_factor = cache_factor * torch.exp(sigma * z_run)
        sample_factor = torch.exp((p.noise_sigma / 2.0)[..., None] * z_samp)
        tput = (t * run_factor)[..., None] * sample_factor      # [..., n]
        iops_s = (iops * run_factor)[..., None] * sample_factor

        def col(x):
            return x[..., None]

        def jitter(v, i, s=0.05):
            return v * torch.exp(s * z_met[..., i, :])

        rpc_mb = torch.minimum(torch.exp2(l - 4.0), c(4.0))
        latency = 0.05 * (1.0 + 3.0 * util ** 2)
        write_mb = tput * col(p.write_frac)
        read_mb = tput - write_mb
        cur_dirty = jitter(write_mb * 2.0 * MiB, 0)
        cur_grant = jitter((col(sc * 32.0) + write_mb) * MiB, 1)
        rpc_div = col(torch.maximum(rpc_mb, c(1e-3)))
        read_rpcs = jitter(read_mb / rpc_div * col(latency), 2)
        write_rpcs = jitter(write_mb / rpc_div * col(latency), 3)
        util2 = col(util ** 2)
        pend_r = jitter((read_mb / 4.0) * 256.0 * util2, 4)
        pend_w = jitter((write_mb / 4.0) * 256.0 * util2, 5)
        cache_hit = torch.clamp(
            col(p.cache_base + 0.45 * (warmth_eff - 0.5)
                + 0.03 * (l - L_DEFAULT) - 0.2 * util)
            + 0.02 * z_met[..., 6, :], 0.0, 1.0)
        cpu_idle = torch.clamp(
            col(100.0 - 55.0 * p.meta_rate - 25.0 * util)
            + 2.0 * z_met[..., 7, :], 0.0, 100.0)
        iowait = torch.clamp(
            col(35.0 * p.meta_rate * (0.5 + util) + 8.0 * util)
            + 1.5 * z_met[..., 8, :], 0.0, 100.0)
        ram = torch.clamp(
            col(28.0 + 40.0 * util) + write_mb * 2.0 / (16.0 * 1024.0) * 100.0
            + 1.5 * z_met[..., 9, :], 0.0, 100.0)

        if "max_rpcs_in_flight" in pos:
            cap = col(d[pos["max_rpcs_in_flight"]]["value"]
                      * torch.maximum(sc, c(1.0)))
            pend_r = pend_r + torch.maximum(c(0.0), read_rpcs - cap) * 256.0
            pend_w = pend_w + torch.maximum(c(0.0), write_rpcs - cap) * 256.0
            read_rpcs = torch.minimum(read_rpcs, cap)
            write_rpcs = torch.minimum(write_rpcs, cap)
        if "max_dirty_mb" in pos:
            cap = col(d[pos["max_dirty_mb"]]["value"] * MiB)
            cur_dirty = torch.minimum(cur_dirty, cap)
            cur_grant = torch.minimum(cur_grant, 2.0 * cap + 32.0 * MiB)
        if "read_ahead_mb" in pos:
            ra = d[pos["read_ahead_mb"]]["value"]
            seq = torch.clamp(torch.log2(p.io_kib / 8.0) / 7.0, 0.0, 1.0)
            h = 1.0 - torch.exp(-ra / 48.0)
            h0 = c(1.0 - np.exp(-64.0 / 48.0))
            shift = 0.10 * (1.0 - p.write_frac) * seq * (h / h0 - 1.0)
            cache_hit = torch.clamp(cache_hit + col(shift), 0.0, 1.0)
        if "checksums" in pos:
            ck_on = col(d[pos["checksums"]]["value"] >= 0.5)
            cpu_idle = torch.where(
                ck_on, torch.clamp(cpu_idle - col(8.0 * util), 0.0, 100.0),
                cpu_idle)

        # windowed mean over the run's samples: a serial left-to-right fold,
        # as the reference computes it
        def smean(x):
            acc = x[..., 0]
            for i in range(1, n_samples):
                acc = acc + x[..., i]
            return acc / n_samples

        metrics = torch.stack([
            smean(cur_dirty), smean(cur_grant), smean(read_rpcs),
            smean(write_rpcs), smean(pend_r), smean(pend_w),
            smean(cache_hit), smean(cpu_idle), smean(iowait),
            smean(ram), smean(tput), smean(iops_s)], dim=-1)

        # restart downtime: 12-20 s workload restart, +30 s DFS scope
        cost = torch.where(
            changed_any, u_rst + torch.where(dfs_changed, c(30.0), c(0.0)),
            c(0.0))
        new_state = LustreEnvState(key=state.key, warmth=warmth,
                                   last_values=values)
        return new_state, metrics, cost

    return init_fn, step_fn, perf_fn


class LustreSimModel(EnvModel):
    """``EnvModel`` over the calibrated Lustre surface.

    ``space`` defaults to the paper's 2-D layout pair; pass
    ``magpie8_param_space()`` (with ``dfs_scope=("service_threads",
    "checksums")``) for the 8-knob V2 environment, or build either through
    ``LustreSimEnv.as_model()`` / ``LustreSimV2.as_model()``. ``params``
    live on the CPU; ``ModelEnv`` and the episode engine move them.
    """

    def __init__(self, workload: str = "file_server",
                 space: ParamSpace = None,
                 dfs_scope: tuple = ("service_threads",),
                 run_seconds: float = 120.0, sample_period: float = 10.0):
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; "
                             f"choose from {sorted(WORKLOADS)}")
        self.workload = WORKLOADS[workload]
        self.param_space = space if space is not None else paper_param_space()
        self.dfs_scope = tuple(k for k in dfs_scope
                               if k in self.param_space.names)
        self.metric_specs = lustre_metric_specs()
        self.state_metrics = list(LUSTRE_STATE_METRICS)
        self.run_seconds = run_seconds
        self.sample_period = sample_period
        self.n_samples = max(2, int(run_seconds / sample_period))
        self.params = LustreParams.from_workload(self.workload)
        self._init_fn, self._step_fn, self._perf_fn = build_lustre_fns(
            self.param_space, self.dfs_scope, run_seconds, sample_period)

    @property
    def init_fn(self):
        return self._init_fn

    @property
    def step_fn(self):
        return self._step_fn

    def step_draws(self, key: torch.Tensor) -> tuple:
        return step_draws(key, self.n_samples)

    def mean_performance(self, config: dict) -> dict:
        """Noise-free steady-state performance for a config (float32)."""
        action = torch.from_numpy(self.param_space.to_action(config))
        perf = self._perf_fn(self.params, action)
        return {k: float(v) for k, v in perf.items()}
