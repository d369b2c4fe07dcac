"""Calibrated Lustre-cluster simulator (the paper's evaluation environment).

Hardware model = the paper's cluster (§III-B): 6 OST nodes + 3 client nodes on
a single 1 GbE switch, HDD-backed OSTs. The two tuned static parameters are the
paper's (§III-A): ``stripe_count`` in {1..6} and ``stripe_size`` in powers of
two from 64 KiB to 64 MiB (Lustre defaults: count 1, size 1 MiB).

The response surface encodes the real mechanisms that make these parameters
matter on such a cluster:
  * striping parallelism P(sc): more OSTs serve one file -> higher aggregate
    bandwidth, sub-linear (gamma) and with cross-client contention (beta);
    large sequential writes scale best (the paper's +250.4% headroom),
    metadata-heavy small-file work *degrades* with striping (File Server).
  * stripe-size response S(ss): RPC efficiency vs seek/imbalance trade-off,
    workload-dependent optimum (small for small random I/O, large for
    streaming), expressed on l = log2(ss / 64 KiB).
  * interaction X(sc, ss): very large stripes on many OSTs cause imbalance
    (fewer stripes than OSTs in flight) — parameters are not independent.
  * aggregate caps: 3 x 117 MB/s client NICs; 6 x ~160 MB/s HDDs.
  * multiplicative lognormal noise, per-run and per-sample, workload-specific
    (File Server has the highest variance, matching the paper's observation).

All Table-I metrics are derived *consistently* with the produced throughput
(queueing-style: in-flight RPC counts rise super-linearly near saturation,
dirty/grant bytes follow the write share and stripe width, MDS iowait follows
metadata intensity). That coupling is what gives Magpie's metric-state its
advantage over black-box search — exactly the paper's thesis.

This module is a *simulator* of the paper's physical testbed: the RL algorithm
above it is unchanged. Calibration targets & checks live in
tests/test_env_calibration.py.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.action_mapping import ParamSpace, ParamSpec
from repro_torch.envs.base import TuningEnvironment
from repro_torch.envs.metrics import (
    LUSTRE_STATE_METRICS,
    MetricsCollector,
    couple_client_knobs,
    lustre_metric_specs,
    MiB,
)
from repro_torch.envs.workloads import WORKLOADS, Workload, param_arrays

# -- cluster constants (paper §III-B) ---------------------------------------
NUM_OSTS = 6
NUM_CLIENTS = 3
CLIENT_NIC_MBPS = 117.0          # 1 GbE payload
HDD_MBPS = 160.0                 # per-OST sequential media bandwidth
NET_CAP = NUM_CLIENTS * CLIENT_NIC_MBPS
L_DEFAULT = 4.0                  # log2(1 MiB / 64 KiB)
PAGE_KIB = 4.0                   # client page size (max_pages_per_rpc unit)

STRIPE_SIZES = tuple(int(64 * 1024 * 2 ** i) for i in range(11))  # 64KiB..64MiB


def paper_param_space() -> ParamSpace:
    """The paper's two static parameters (§III-A)."""
    return ParamSpace(specs=(
        ParamSpec("stripe_count", "discrete", minimum=1, maximum=NUM_OSTS, default=1),
        ParamSpec("stripe_size", "choice", values=STRIPE_SIZES,
                  default=int(1 * MiB)),
    ))


def extended_param_space() -> ParamSpace:
    """Beyond-paper: adds an OSS service-thread count (DFS-restart scope)."""
    return ParamSpace(specs=(
        ParamSpec("stripe_count", "discrete", minimum=1, maximum=NUM_OSTS, default=1),
        ParamSpec("stripe_size", "choice", values=STRIPE_SIZES,
                  default=int(1 * MiB)),
        ParamSpec("service_threads", "choice",
                  values=(8, 16, 32, 64, 128, 256, 512), default=64),
    ))


def magpie8_param_space() -> ParamSpace:
    """The realistic 8-knob mixed-type space (``LustreSimV2``).

    Layers the DIAL/CARAT-style client knobs on the paper's layout pair plus
    the OSS thread count; defaults are Lustre's. Kinds exercise every
    ``ParamSpec`` flavour: discrete, log2-integer, boolean and categorical.
    """
    return ParamSpace(specs=(
        # layout (the paper's §III-A pair, workload-restart scope)
        ParamSpec("stripe_count", "discrete", minimum=1, maximum=NUM_OSTS,
                  default=1),
        ParamSpec("stripe_size", "log2_int", minimum=STRIPE_SIZES[0],
                  maximum=STRIPE_SIZES[-1], default=int(1 * MiB)),
        # client-side OSC knobs (lctl set_param scope -> workload restart)
        ParamSpec("max_rpcs_in_flight", "log2_int", minimum=1, maximum=256,
                  default=8),
        ParamSpec("max_pages_per_rpc", "log2_int", minimum=32, maximum=1024,
                  default=256),
        ParamSpec("max_dirty_mb", "log2_int", minimum=4, maximum=2048,
                  default=32),
        ParamSpec("read_ahead_mb", "log2_int", minimum=1, maximum=1024,
                  default=64),
        # wire checksumming (remount -> DFS-restart scope)
        ParamSpec("checksums", "boolean", default=True),
        # OSS service threads (server restart -> DFS-restart scope)
        ParamSpec("service_threads", "categorical",
                  values=(8, 16, 32, 64, 128, 256, 512), default=64),
    ))


def _knob_column(configs, name: str, default: float):
    """Presence mask + float values (``default`` where absent) for one knob."""
    has = np.array([name in c for c in configs])
    val = np.array([float(c.get(name, default)) for c in configs])
    return has, val


def _client_knob_factor(configs, w, sc, l) -> np.ndarray:
    """Multiplicative throughput response of the V2 client knobs.

    Every factor is exactly 1.0 when its knob is absent from the config AND at
    the knob's Lustre default under the default layout — so the paper's 2-D
    space sees the identical surface it always did, while
    ``magpie8_param_space`` configs move on an 8-D response with the
    DIAL/CARAT interactions: RPC concurrency x stripe width, RPC size x stripe
    size, dirty-cache depth x write share, read-ahead x sequentiality.
    """
    n = len(configs)
    factor = np.ones(n)
    wf, meta = w["write_frac"], w["meta_rate"]

    # max_rpcs_in_flight: per-OST concurrency keeps the pipe full; wide
    # layouts split the per-OSC budget across sc OSTs, so striping wider
    # WITHOUT raising the RPC budget starves each OST (CARAT's co-tuning
    # argument); oversized budgets add server-side contention on
    # metadata-heavy work.
    has, rif = _knob_column(configs, "max_rpcs_in_flight", 8.0)
    if has.any():
        per_ost = rif / np.maximum(sc, 1)
        conc = per_ost / (per_ost + 2.0)
        conc0 = 8.0 / (8.0 + 2.0)        # default budget on an unstriped file
        over = 1.0 - 0.03 * meta * np.maximum(
            0.0, np.log2(np.maximum(rif, 1.0)) - 5.0)
        factor *= np.where(has, conc / conc0 * np.maximum(over, 0.7), 1.0)

    # max_pages_per_rpc: the wire RPC is min(pages * 4 KiB, stripe_size);
    # streaming work wants full-size RPCs, small random I/O wastes them.
    has, pages = _knob_column(configs, "max_pages_per_rpc", 256.0)
    if has.any():
        stripe_kib = 2.0 ** l * 64.0
        lr_opt = np.clip(w["l_opt"], 0.0, 4.0)

        def rpc_resp(pg):
            lr = np.log2(np.minimum(pg * PAGE_KIB, stripe_kib) / 64.0)
            return 1.0 + 0.10 * (1.0 - ((lr - lr_opt) / 4.0) ** 2)

        factor *= np.where(
            has, rpc_resp(pages) / rpc_resp(np.full(n, 256.0)), 1.0)

    # max_dirty_mb: write-back pipeline depth — too shallow throttles writers
    # behind RPC completion; very deep caches add flush burstiness.
    has, dirty = _knob_column(configs, "max_dirty_mb", 32.0)
    if has.any():
        h = 1.0 - np.exp(-dirty / 24.0)
        h0 = 1.0 - np.exp(-32.0 / 24.0)
        burst = 1.0 - 0.02 * np.maximum(0.0, np.log2(dirty / 512.0))
        factor *= np.where(has, ((1.0 - wf) + wf * h / h0) * burst, 1.0)

    # read_ahead_mb: prefetch helps sequential reads, pollutes the client
    # cache on random reads.
    has, ra = _knob_column(configs, "read_ahead_mb", 64.0)
    if has.any():
        seq = np.clip(np.log2(w["io_kib"] / 8.0) / 7.0, 0.0, 1.0)
        rf = 1.0 - wf
        h = 1.0 - np.exp(-ra / 48.0)
        h0 = 1.0 - np.exp(-64.0 / 48.0)
        gain = 0.25 * rf * seq * (h / h0 - 1.0)
        waste = 0.12 * rf * (1.0 - seq) * np.clip(
            np.log2(ra / 64.0) / 4.0, 0.0, 1.0)
        factor *= np.where(has, 1.0 + gain - waste, 1.0)

    # checksums: CRC on every RPC burns CPU proportional to the write share;
    # Lustre defaults them ON, so disabling is the (risky) gain.
    has_ck = np.array(["checksums" in c for c in configs])
    ck_on = np.array([bool(c.get("checksums", True)) for c in configs])
    if has_ck.any():
        relief = 1.04 + 0.06 * wf
        factor *= np.where(has_ck & ~ck_on, relief, 1.0)

    return factor


def batch_mean_performance(envs, configs) -> list:
    """Noise-free response surface for N (env, config) sessions in one pass.

    THE surface implementation: ``LustreSimEnv.mean_performance`` is the
    N == 1 case, so the fleet fast path (one vectorized evaluation per fleet
    step) and the scalar path agree by construction. Per-session workload
    shape parameters come from ``workloads.param_arrays``.
    """
    if len(envs) != len(configs):
        raise ValueError("need one config per env")
    for env, config in zip(envs, configs):
        if not env.param_space.validate(config):
            raise ValueError(f"invalid config {config}")

    w = param_arrays([env.workload for env in envs])
    sc = np.array([int(c["stripe_count"]) for c in configs])
    ss = np.array([int(c["stripe_size"]) for c in configs])
    gamma, beta = w["gamma"], w["beta"]
    l_gate, gate_width = w["l_gate"], w["gate_width"]
    l_opt, l_width, s_amp = w["l_opt"], w["l_width"], w["s_amp"]
    base, io_kib = w["base_mbps"], w["io_kib"]

    l = np.log2(ss / (64 * 1024))

    # striping parallelism vs contention
    p = sc ** gamma * np.exp(-beta * (sc - 1))
    # striping-efficiency gate: wide layouts only pay off with stripes big
    # enough for full-size RPCs (narrow ridge in (sc, ss) space -> strong
    # parameter interaction, the paper's 'dependencies among parameters')
    r_gate = 1.0 / (1.0 + np.exp(-(l - l_gate) / gate_width))
    p_eff = np.where(p >= 1.0, 1.0 + (p - 1.0) * r_gate, p)

    # stripe-size response, normalized to 1 at the default (1 MiB)
    def s_raw(ll):
        return 1.0 + s_amp * (1.0 - ((ll - l_opt) / l_width) ** 2)

    s = np.maximum(0.4, s_raw(l)) / np.maximum(0.4, s_raw(L_DEFAULT))
    # interaction: stripes wider than ~16 MiB underfill wide layouts
    x = 1.0 - 0.03 * np.maximum(0, sc - 1) * np.maximum(0.0, l - 8.0)
    x = np.maximum(0.6, x)

    t = base * p_eff * s * x

    # beyond-paper knob: OSS service threads (peak near 128)
    threads = np.array([float(c.get("service_threads", 0)) for c in configs])
    has_threads = threads > 0
    if has_threads.any():
        th = np.where(has_threads, threads, 1.0)
        factor = 0.75 + 0.33 * np.exp(-((np.log2(th) - 7.0) / 3.0) ** 2)
        t = np.where(has_threads, t * factor, t)

    # V2 client knobs (LustreSimV2 / magpie8_param_space); exactly 1 for
    # configs that omit them, so the paper's 2-D surface is unchanged.
    t = t * _client_knob_factor(configs, w, sc, l)

    # physical caps: client NICs in aggregate; sc OSTs of media bandwidth
    t = np.minimum(np.minimum(t, NET_CAP * 0.95), sc * HDD_MBPS * 1.05)

    # IOPS: ops rate = bytes / effective op size; finer stripes raise the
    # server-visible op rate (RPC amplification) — the multi-objective
    # tension of §III-D.
    amp = 1.0 + 0.6 * np.maximum(0.0, (L_DEFAULT - l)) / L_DEFAULT
    iops = t * 1024.0 / io_kib * amp
    util = t / NET_CAP

    return [
        {"throughput": float(t[i]), "iops": float(iops[i]),
         "util": float(util[i]), "l": float(l[i]), "sc": int(sc[i])}
        for i in range(len(envs))
    ]


class LustreSimEnv(TuningEnvironment):
    #: parameters whose change needs a full-DFS restart (vs workload restart)
    DFS_SCOPE = ("service_threads",)

    def __init__(self, workload: str = "file_server", seed: int = 0,
                 extended: bool = False, run_seconds: float = 120.0,
                 sample_period: float = 10.0):
        if workload not in WORKLOADS:
            raise ValueError(f"unknown workload {workload!r}; "
                             f"choose from {sorted(WORKLOADS)}")
        self.workload: Workload = WORKLOADS[workload]
        self.param_space = extended_param_space() if extended else paper_param_space()
        self.metric_specs = lustre_metric_specs()
        self.state_metrics = list(LUSTRE_STATE_METRICS)
        self.run_seconds = run_seconds
        self.sample_period = sample_period
        self.collector = MetricsCollector()
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self.sim_clock = 0.0  # simulated seconds elapsed (runs + restarts)
        self.restart_events: list = []  # (scope, seconds) per config change
        # Latent client-cache warmth in [0,1]: persists across runs, cooled by
        # layout changes, drives the *explainable* share of short-run variance.
        self._warmth = 0.5
        self._last_config: dict = {}

    # ------------------------------------------------------------------
    # Response surface
    # ------------------------------------------------------------------

    def mean_performance(self, config: dict) -> dict:
        """Noise-free steady-state performance + internals for a config.

        Exposed separately so tests/benchmarks can query the true surface
        (e.g. to locate the global optimum for regret checks). The N == 1
        case of ``batch_mean_performance`` — one shared surface implementation.
        """
        return batch_mean_performance([self], [config])[0]

    def _internal_metrics(self, perf: dict, config: dict,
                          rng: np.random.Generator) -> dict:
        """Table-I metrics, consistent with the delivered performance."""
        w = self.workload
        t, util, l, sc = perf["throughput"], perf["util"], perf["l"], perf["sc"]
        rpc_mb = min(2 ** l * 64 / 1024.0, 4.0)  # RPC <= 4 MiB
        latency = 0.05 * (1.0 + 3.0 * util ** 2)  # queueing delay near saturation
        write_mb = t * w.write_frac
        read_mb = t - write_mb

        def jitter(v, s=0.05):
            return float(v * rng.lognormal(0.0, s))

        metrics = {
            "cur_dirty_bytes": jitter(write_mb * 2.0 * MiB),  # ~2 s writeback window
            "cur_grant_bytes": jitter((sc * 32 + write_mb) * MiB),
            "read_rpcs_in_flight": jitter(read_mb / max(rpc_mb, 1e-3) * latency),
            "write_rpcs_in_flight": jitter(write_mb / max(rpc_mb, 1e-3) * latency),
            "pending_read_pages": jitter((read_mb / 4.0) * 256.0 * util ** 2),
            "pending_write_pages": jitter((write_mb / 4.0) * 256.0 * util ** 2),
            "cache_hit_ratio": float(np.clip(
                w.cache_base + 0.45 * (perf.get("warmth", 0.5) - 0.5)
                + 0.03 * (l - L_DEFAULT) - 0.2 * util
                + rng.normal(0.0, 0.02), 0.0, 1.0)),
            "cpu_usage_idle": float(np.clip(
                100.0 - 55.0 * w.meta_rate - 25.0 * util + rng.normal(0, 2.0),
                0.0, 100.0)),
            "cpu_usage_iowait": float(np.clip(
                35.0 * w.meta_rate * (0.5 + util) + 8.0 * util
                + rng.normal(0, 1.5), 0.0, 100.0)),
            "ram_used_percent": float(np.clip(
                28.0 + 40.0 * util + write_mb * 2.0 / (16 * 1024.0) * 100.0
                + rng.normal(0, 1.5), 0.0, 100.0)),
        }
        # Client-knob visibility (no RNG draws -> fleet parity preserved):
        # knob limits clamp the metric they govern, read-ahead/checksums shift
        # cache and CPU metrics. No-op for the paper's 2-D configs.
        seq = float(np.clip(np.log2(w.io_kib / 8.0) / 7.0, 0.0, 1.0))
        return couple_client_knobs(metrics, config, util=util,
                                   stripe_count=sc, write_frac=w.write_frac,
                                   seq=seq)

    # ------------------------------------------------------------------
    # TuningEnvironment interface
    # ------------------------------------------------------------------

    def apply(self, config: dict, eval_run: bool = False) -> dict:
        """Simulate one workload run under ``config``; return windowed metrics.

        ``eval_run``: final-evaluation runs are 30 minutes instead of 2 (paper
        §III-B) — longer runs average down the run-to-run variance by ~sqrt(T).
        """
        return self._run_with_perf(self.mean_performance(config), config,
                                   eval_run)

    def _run_with_perf(self, perf: dict, config: dict,
                       eval_run: bool = False) -> dict:
        """The stochastic half of ``apply``: noise, cache warmth, sampling.

        Split out so the fleet path can compute ``perf`` for every session in
        one vectorized ``batch_mean_performance`` call and still consume each
        environment's RNG stream exactly as the scalar ``apply`` would.
        """
        w = self.workload
        run_seconds = 1800.0 if eval_run else self.run_seconds

        # Latent cache warmth: layout change flushes caches; otherwise AR(1).
        if config != self._last_config:
            self._warmth *= 0.4
        self._last_config = dict(config)
        self._warmth = 0.6 * self._warmth + 0.4 * float(self._rng.uniform())
        # Long evaluation runs reach cache steady state -> neutral warmth.
        warmth_eff = 0.5 if eval_run else self._warmth

        # Explainable variance: warm caches inflate short-run throughput and
        # are visible in cache_hit_ratio — Magpie's critic can attribute it;
        # black-box argmax over noisy samples cannot.
        cache_factor = float(np.exp(w.cache_kappa * (warmth_eff - 0.5)))
        # Unexplainable variance, heteroscedastic: lightly-loaded (bad)
        # configs have unstable queueing and noisier short-run throughput.
        het = 1.4 - 0.8 * min(1.0, perf["util"])
        sigma = w.noise_sigma * het * float(np.sqrt(self.run_seconds / run_seconds))
        run_factor = cache_factor * self._rng.lognormal(0.0, sigma)
        n = max(2, int(self.run_seconds / self.sample_period))
        for i in range(n):
            t_abs = self.sim_clock + (i + 1) * self.sample_period
            sample_factor = self._rng.lognormal(0.0, w.noise_sigma / 2.0)
            tput = perf["throughput"] * run_factor * sample_factor
            iops = perf["iops"] * run_factor * sample_factor
            sample = {"throughput": tput, "iops": iops}
            sample.update(self._internal_metrics(
                {**perf, "throughput": tput, "warmth": warmth_eff}, config,
                self._rng))
            self.collector.ingest(t_abs, sample)
        self.sim_clock += run_seconds
        return self.collector.window_mean(
            self.state_metrics, horizon=self.run_seconds - 1e-6)

    def restart_cost(self, config: dict, prev_config: dict) -> float:
        """Paper §III-F: 12-20 s workload restart; ~30 s extra for DFS restart.

        Every restart is logged to ``restart_events`` with its scope so
        downtime can be attributed per knob class (``restart_summary``) — the
        accounting §III-F argues makes static parameters expensive to tune
        online. The log spans the environment's lifetime; clear
        ``restart_events`` at an episode boundary to scope it (progressive
        tuning reuses the env across ``run()`` calls).
        """
        changed = [k for k in config if config[k] != prev_config.get(k)]
        if not changed:
            return 0.0
        cost = float(self._rng.uniform(12.0, 20.0))  # workload restart
        scope = "workload"
        if any(k in self.DFS_SCOPE for k in changed):
            cost += 30.0  # DFS restart
            scope = "dfs"
        self.sim_clock += cost
        self.restart_events.append((scope, cost))
        return cost

    def restart_summary(self) -> dict:
        """Restart accounting over ``restart_events``: {scope: {count,
        seconds}}. Covers the env's whole life; clear ``restart_events``
        between episodes to get per-episode numbers."""
        out = {"workload": {"count": 0, "seconds": 0.0},
               "dfs": {"count": 0, "seconds": 0.0}}
        for scope, seconds in self.restart_events:
            out[scope]["count"] += 1
            out[scope]["seconds"] += seconds
        return out

    # pure-model twin (the whole-episode engine's env core) ---------------

    def as_model(self):
        """The pure-function twin of this environment: same parameter space,
        workload, surface and metric coupling as ``EnvModel`` torch functions
        (``envs.lustre_model.LustreSimModel``). Its noise has the same
        structure draw for draw but flows through a threefry key instead of
        this instance's numpy Generator: a model of the same system, not a
        replay of this instance's stream."""
        from repro_torch.envs.lustre_model import LustreSimModel
        return LustreSimModel(
            self.workload.name, space=self.param_space,
            dfs_scope=type(self).DFS_SCOPE,
            run_seconds=self.run_seconds, sample_period=self.sample_period)

    def to_model_env(self, seed: int = None, device=None):
        """``ModelEnv`` host adapter over ``as_model()`` on ``device``
        (``cuda`` unless given)."""
        from repro_torch.envs.base import ModelEnv
        return ModelEnv(self.as_model(),
                        seed=self._seed if seed is None else seed,
                        device=device)

    # convenience for tests / benchmarks ---------------------------------

    def _score_batch(self, configs: list, weights: dict) -> np.ndarray:
        """Scalarized noise-free objective for N configs in one surface pass."""
        perfs = batch_mean_performance([self] * len(configs), configs)
        return np.array([
            sum(wt * self.metric_specs[name].norm(p[name])
                for name, wt in weights.items())
            for p in perfs])

    def true_optimum(self, weights: dict) -> tuple:
        """Grid-search the noise-free surface for the scalarized optimum."""
        configs = self.param_space.grid(16)
        scores = self._score_batch(configs, weights)
        i = int(np.argmax(scores))
        return configs[i], float(scores[i])


class LustreSimV2(LustreSimEnv):
    """The 8-knob mixed-type environment (``magpie8_param_space``).

    Same cluster, workloads, metric pipeline and noise model as
    ``LustreSimEnv``; the static-parameter space grows from the paper's 2-D
    layout pair to the realistic 8-D client+server space (DIAL/CARAT knobs),
    with the response-surface interactions and Table-I metric coupling
    implemented in ``_client_knob_factor`` / ``couple_client_knobs``. Under
    the all-defaults configuration the only factor differing from the 2-D
    surface is the service-thread response, so headroom comparisons against
    ``LustreSimEnv`` stay meaningful.

    Restart scopes: ``checksums`` (remount) and ``service_threads`` (server
    restart) need a full-DFS restart; the client OSC knobs and the layout
    pair take a workload restart only.
    """

    DFS_SCOPE = ("service_threads", "checksums")

    def __init__(self, workload: str = "file_server", seed: int = 0,
                 run_seconds: float = 120.0, sample_period: float = 10.0):
        super().__init__(workload, seed=seed, extended=False,
                         run_seconds=run_seconds, sample_period=sample_period)
        self.param_space = magpie8_param_space()

    def true_optimum(self, weights: dict, samples: int = 2048,
                     sweeps: int = 2) -> tuple:
        """Random sample + coordinate descent on the noise-free surface.

        The full 8-D space has ~5.5M distinct configs — exhaustive enumeration stops being
        an oracle exactly where the paper says RL should win. ``samples``
        LHS-free uniform draws seed a coordinate descent that sweeps each
        parameter's full value set (finite for all non-continuous kinds).
        """
        rng = np.random.default_rng(0)
        space = self.param_space
        configs = space.to_configs(rng.uniform(size=(samples, space.dim)))
        scores = self._score_batch(configs, weights)
        i = int(np.argmax(scores))
        best, best_score = configs[i], float(scores[i])
        for _ in range(sweeps):
            for spec in space.specs:
                card = spec.cardinality or 9
                values = spec.from_unit_batch(np.linspace(0.0, 1.0, card))
                cands = [{**best, spec.name: v} for v in values]
                s = self._score_batch(cands, weights)
                j = int(np.argmax(s))
                if float(s[j]) > best_score:
                    best, best_score = cands[j], float(s[j])
        return best, best_score
