"""Metric specifications (paper Table I) + a windowed metrics collector.

The collector plays Telegraf+InfluxDB's role in the paper's architecture: it
ingests time-stamped samples from the environment during a workload run and
answers windowed-average queries. The normalization bounds below are the
'domain knowledge' bounds of §II-B-3, sized for the paper's cluster (6 OSTs on
1 GbE, 16 GB RAM nodes).
"""

from __future__ import annotations

import collections
from typing import Mapping

import numpy as np

from repro_torch.core.scalarization import MetricSpec

MiB = 1024.0 * 1024.0


def lustre_metric_specs() -> Mapping[str, MetricSpec]:
    """Table I metrics + the two performance indicators (throughput, IOPS)."""
    specs = [
        # -- OSC (client) scope, paper Table I -------------------------------
        MetricSpec("cur_dirty_bytes", 0.0, 512 * MiB, "OSC",
                   "Bytes written and cached by this OSC."),
        MetricSpec("cur_grant_bytes", 0.0, 2048 * MiB, "OSC",
                   "Space the client reserved for writeback cache."),
        MetricSpec("read_rpcs_in_flight", 0.0, 256.0, "OSC",
                   "Read RPCs issued but incomplete during snapshot."),
        MetricSpec("write_rpcs_in_flight", 0.0, 256.0, "OSC",
                   "Write RPCs issued but incomplete during snapshot."),
        MetricSpec("pending_read_pages", 0.0, 65536.0, "OSC",
                   "Pending read pages queued for I/O in the OSC."),
        MetricSpec("pending_write_pages", 0.0, 65536.0, "OSC",
                   "Pending write pages queued for I/O in the OSC."),
        MetricSpec("cache_hit_ratio", 0.0, 1.0, "OSC",
                   "Hits / total cache accesses."),
        # -- MDS (server) scope ----------------------------------------------
        MetricSpec("cpu_usage_idle", 0.0, 100.0, "MDS",
                   "CPU idle percentage."),
        MetricSpec("cpu_usage_iowait", 0.0, 100.0, "MDS",
                   "CPU iowait percentage."),
        MetricSpec("ram_used_percent", 0.0, 100.0, "OSC&MDS",
                   "Used RAM percentage."),
        # -- performance indicators (objectives; also part of the state so the
        #    reward r_t = Δ(Σ w_i s(i))/Σ w_i s(i) reads them off the state) --
        MetricSpec("throughput", 0.0, 400.0, "OST",
                   "Aggregate MB/s delivered to clients."),
        MetricSpec("iops", 0.0, 60000.0, "OST",
                   "I/O operations per second."),
    ]
    return {s.name: s for s in specs}


#: Fixed state ordering (k = 12): Table-I metrics first, objectives last.
LUSTRE_STATE_METRICS = [
    "cur_dirty_bytes", "cur_grant_bytes", "read_rpcs_in_flight",
    "write_rpcs_in_flight", "pending_read_pages", "pending_write_pages",
    "cache_hit_ratio", "cpu_usage_idle", "cpu_usage_iowait",
    "ram_used_percent", "throughput", "iops",
]


def scope_mask(metric_specs: Mapping[str, MetricSpec], state_metrics,
               scopes) -> np.ndarray:
    """0/1 float32 visibility mask over ``state_metrics`` for ``scopes``.

    A metric is visible when any of its (``&``-joined) scopes is in
    ``scopes`` — e.g. ``ram_used_percent`` ("OSC&MDS") is visible to both an
    OSC-scoped and an MDS-scoped observer. This is the DIAL-style
    decentralized observation model: a client-scope tuner sees only
    client-side (OSC) metrics and must tune from that partial state.
    """
    wanted = {str(s) for s in scopes}
    known = {part for spec in metric_specs.values()
             for part in spec.scope.split("&")}
    unknown = wanted - known
    if unknown:
        raise ValueError(f"unknown metric scopes {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    mask = np.zeros((len(state_metrics),), np.float32)
    for i, name in enumerate(state_metrics):
        parts = set(metric_specs[name].scope.split("&"))
        mask[i] = 1.0 if parts & wanted else 0.0
    return mask


def couple_client_knobs(metrics: dict, config: Mapping, *, util: float,
                        stripe_count: int, write_frac: float,
                        seq: float) -> dict:
    """Couple Table-I metrics to the client knobs of the 8-D space (§III-A).

    The paper's thesis is that server *and client* metrics expose what a knob
    did to the system — black-box search sees only the objective. This helper
    enforces that visibility for the DIAL/CARAT-style client knobs: the metric
    a knob limits is clamped at that limit, and cache/CPU metrics shift with
    read-ahead and checksumming. Knobs absent from ``config`` (the paper's 2-D
    space) leave the metrics untouched, and no RNG is consumed, so the scalar
    and fleet sampling streams stay aligned.

    ``util`` is delivered-throughput / network capacity in [0, 1]; ``seq`` is
    the workload's sequentiality in [0, 1] (0 = random I/O).
    """
    out = dict(metrics)
    if "max_rpcs_in_flight" in config:
        # per-OSC, per-OST concurrency limit aggregated over the stripe width
        cap = float(config["max_rpcs_in_flight"]) * max(1, int(stripe_count))
        spill_r = max(0.0, out["read_rpcs_in_flight"] - cap)
        spill_w = max(0.0, out["write_rpcs_in_flight"] - cap)
        out["read_rpcs_in_flight"] = min(out["read_rpcs_in_flight"], cap)
        out["write_rpcs_in_flight"] = min(out["write_rpcs_in_flight"], cap)
        # RPCs denied a slot queue as pending pages (256 pages per 1 MiB RPC)
        out["pending_read_pages"] += spill_r * 256.0
        out["pending_write_pages"] += spill_w * 256.0
    if "max_dirty_mb" in config:
        cap = float(config["max_dirty_mb"]) * MiB
        out["cur_dirty_bytes"] = min(out["cur_dirty_bytes"], cap)
        out["cur_grant_bytes"] = min(out["cur_grant_bytes"],
                                     2.0 * cap + 32.0 * MiB)
    if "read_ahead_mb" in config:
        ra = float(config["read_ahead_mb"])
        h = 1.0 - np.exp(-ra / 48.0)
        h0 = 1.0 - np.exp(-64.0 / 48.0)
        shift = 0.10 * (1.0 - write_frac) * seq * (h / h0 - 1.0)
        out["cache_hit_ratio"] = float(
            np.clip(out["cache_hit_ratio"] + shift, 0.0, 1.0))
    if "checksums" in config and bool(config["checksums"]):
        # CRC32 on every RPC burns client/server CPU proportional to traffic
        out["cpu_usage_idle"] = float(
            np.clip(out["cpu_usage_idle"] - 8.0 * util, 0.0, 100.0))
    return out


class MetricsCollector:
    """Ring-buffered time-series store with windowed-average queries.

    ``ingest(t, {name: value})`` appends samples; ``window_mean(names, horizon)``
    averages the last ``horizon`` seconds — what the paper's 'Metrics Collector'
    queries from InfluxDB after each action step.
    """

    def __init__(self, capacity: int = 4096):
        self._series: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=capacity)
        )

    def ingest(self, t: float, sample: Mapping[str, float]) -> None:
        for name, value in sample.items():
            self._series[name].append((float(t), float(value)))

    def window_mean(self, names, horizon: float) -> dict:
        out = {}
        for name in names:
            series = self._series.get(name)
            if not series:
                raise KeyError(f"no samples for metric {name!r}")
            t_end = series[-1][0]
            vals = [v for (t, v) in series if t >= t_end - horizon]
            out[name] = sum(vals) / len(vals)
        return out

    def latest(self, name: str) -> float:
        return self._series[name][-1][1]

    def __contains__(self, name: str) -> bool:
        return name in self._series and len(self._series[name]) > 0
