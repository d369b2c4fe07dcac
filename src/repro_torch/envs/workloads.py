"""Filebench workload models (paper Table II).

Each workload is a parametric I/O character used by the Lustre simulator's
response surface. The shape parameters are calibrated (see tests/test_env_
calibration.py) so the *optimal-over-default* throughput headroom per workload
matches the paper's reported tuning gains: Sequential Write ~+250% (paper:
+250.4%), and a ~92% average across the five workloads (paper: 91.8%).

Response-surface form (see lustre_sim.py):
    T(sc, ss) = base_mbps * P(sc) * S(log2 ss) * X(sc, ss) * noise
    P(sc) = sc^gamma * exp(-beta (sc-1))          # striping parallelism vs contention
    S(l)  = (1 + s_amp (1 - ((l-l_opt)/l_width)^2)) / (same at l_default)
with l = log2(stripe_size / 64 KiB) in [0, 10] and l_default = 4 (1 MiB).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    description: str
    base_mbps: float      # single-OST throughput at default stripe size
    gamma: float          # striping parallelism exponent
    beta: float           # striping contention penalty
    l_opt: float          # optimal log2(stripe/64KiB)
    l_width: float        # stripe-size sensitivity width
    s_amp: float          # stripe-size response amplitude
    io_kib: float         # mean application I/O size (KiB) -> IOPS scale
    write_frac: float     # fraction of bytes written (vs read)
    meta_rate: float      # metadata ops intensity in [0, 1] (MDS load)
    cache_base: float     # baseline client cache hit ratio
    noise_sigma: float    # multiplicative lognormal noise (File Server highest)
    # Striping-efficiency gate: striping across sc OSTs only pays off once the
    # stripe is large enough for full-size RPCs (small stripes on wide layouts
    # shatter each request into tiny per-OST RPCs + seeks). R(l) =
    # sigmoid((l - l_gate)/gate_width); l_gate < 0 disables the gate.
    l_gate: float = -10.0
    gate_width: float = 0.8
    # Sensitivity of short-run measured throughput to client cache warmth, a
    # latent AR(1) state that persists across runs, is cooled by layout
    # changes, is *visible* to Magpie through cache_hit_ratio, and averages
    # out in 30-minute evaluation runs. This is the explainable part of the
    # measurement variance (the unexplainable part is noise_sigma).
    cache_kappa: float = 0.30


def param_arrays(workloads) -> dict:
    """Per-workload shape parameters packed as {field: np.array([N])}.

    The vectorized response surface (``lustre_sim.batch_mean_performance``)
    evaluates N sessions with different workloads in one numpy pass; this
    keeps the field list in the module that owns the dataclass.
    """
    fields = ("base_mbps", "gamma", "beta", "l_opt", "l_width", "s_amp",
              "io_kib", "l_gate", "gate_width", "write_frac", "meta_rate")
    return {f: np.array([getattr(w, f) for w in workloads]) for f in fields}


WORKLOADS = {
    "file_server": Workload(
        name="file_server",
        description="Creates/deletes/appends/reads/writes/attrs on many small files",
        base_mbps=62.0, gamma=0.10, beta=0.15, l_opt=1.0, l_width=3.5, s_amp=0.70,
        io_kib=16.0, write_frac=0.55, meta_rate=0.90, cache_base=0.35,
        noise_sigma=0.18, cache_kappa=0.50,
    ),
    "video_server": Workload(
        name="video_server",
        description="Streams active videos, writes inactive set",
        base_mbps=98.0, gamma=0.25, beta=0.025, l_opt=8.0, l_width=4.5, s_amp=0.30,
        io_kib=512.0, write_frac=0.15, meta_rate=0.10, cache_base=0.55,
        noise_sigma=0.10, cache_kappa=0.35, l_gate=4.0, gate_width=1.0,
    ),
    "seq_write": Workload(
        name="seq_write",
        description="Sequential write of 5 files with multiple threads",
        base_mbps=88.0, gamma=0.68, beta=0.015, l_opt=6.0, l_width=3.0, s_amp=0.55,
        io_kib=1024.0, write_frac=1.00, meta_rate=0.05, cache_base=0.10,
        noise_sigma=0.12, cache_kappa=0.15, l_gate=5.0, gate_width=0.6,
    ),
    "seq_read": Workload(
        name="seq_read",
        description="Sequential read of 5 files with multiple threads",
        base_mbps=105.0, gamma=0.30, beta=0.040, l_opt=7.0, l_width=4.0, s_amp=0.50,
        io_kib=1024.0, write_frac=0.00, meta_rate=0.05, cache_base=0.60,
        noise_sigma=0.10, cache_kappa=0.45, l_gate=4.5, gate_width=0.8,
    ),
    "random_rw": Workload(
        name="random_rw",
        description="One thread random-reads, one random-writes a large file",
        base_mbps=45.0, gamma=0.30, beta=0.060, l_opt=2.0, l_width=4.0, s_amp=0.55,
        io_kib=8.0, write_frac=0.50, meta_rate=0.15, cache_base=0.25,
        noise_sigma=0.14, cache_kappa=0.35,
    ),
}
