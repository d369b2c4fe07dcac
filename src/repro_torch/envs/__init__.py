from repro_torch.envs.base import EnvModel, ModelEnv, TuningEnvironment
from repro_torch.envs.faults import (
    FAULT_MODES,
    ChaosConfig,
    HostChaos,
    TransientChunkError,
    FaultInjectedModel,
    FaultSpec,
    FaultyEnvState,
    latency_spike,
    metric_dropout,
    nan_poison,
    throughput_collapse,
)
from repro_torch.envs.metrics import (
    LUSTRE_STATE_METRICS,
    MetricsCollector,
    couple_client_knobs,
    lustre_metric_specs,
    scope_mask,
)
from repro_torch.envs.workloads import WORKLOADS, Workload
from repro_torch.envs.lustre_sim import (
    LustreSimEnv,
    LustreSimV2,
    batch_mean_performance,
    extended_param_space,
    magpie8_param_space,
    paper_param_space,
)

__all__ = [
    "TuningEnvironment", "EnvModel", "ModelEnv", "FAULT_MODES",
    "FaultInjectedModel", "FaultSpec", "FaultyEnvState", "latency_spike",
    "ChaosConfig", "HostChaos", "TransientChunkError", "scope_mask",
    "metric_dropout", "nan_poison", "throughput_collapse",
    "MetricsCollector", "lustre_metric_specs",
    "LUSTRE_STATE_METRICS", "couple_client_knobs", "WORKLOADS", "Workload",
    "LustreSimEnv", "LustreSimV2", "batch_mean_performance",
    "paper_param_space", "extended_param_space", "magpie8_param_space",
]
