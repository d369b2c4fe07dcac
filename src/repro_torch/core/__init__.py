from repro_torch.core.action_mapping import ParamSpace, ParamSpec
from repro_torch.core.agent import MagpieAgent, lhs_warmup_plan
from repro_torch.core.ddpg import DDPGConfig, DDPGState, ddpg_init, \
    fleet_act, fleet_init, fleet_learn_scan
from repro_torch.core.episode import last_fleet_run_stats, \
    live_device_bytes, precompile_fleet_episode, resolve_chunk, \
    run_episode_scan, run_fleet_episode_scan, stepwise_episode, \
    stream_chunks
from repro_torch.core.fleet import FleetAgent, FleetResult, FleetTuner, \
    evaluate_fleet, memory_plan, replay_compact_trace
from repro_torch.core.guardrails import DeploymentPolicy, GuardState, \
    GuardedEpisodeTrace, empty_counters, gate_decision, \
    guardrail_counters, guardrail_stats, init_fleet_guard_state, \
    init_guard_state, merge_counters, rollback_decision
from repro_torch.core.replay_buffer import BatchedReplayBuffer, ReplayBuffer
from repro_torch.core.resilience import ChunkFailure, ChunkSupervisor, \
    HealthState, ResiliencePolicy, ResilientEpisodeTrace, \
    health_counters, health_decision, health_stats, \
    init_fleet_health_state, init_health_state, merge_health_counters, \
    normalize_resilience, normalize_supervisor
from repro_torch.core.sharing import SharingConfig, normalize_sharing, \
    resolve_obs_mask
from repro_torch.core.scalarization import MetricSpec, Scalarizer, \
    normalize_state
from repro_torch.core.service import FleetService
from repro_torch.core.tuner import StepRecord, Tuner, TuningResult, \
    evaluate_config, recommend_final

__all__ = [
    "ParamSpace", "ParamSpec", "MagpieAgent", "lhs_warmup_plan",
    "DDPGConfig", "DDPGState", "ddpg_init", "fleet_act", "fleet_init",
    "fleet_learn_scan", "last_fleet_run_stats", "live_device_bytes",
    "precompile_fleet_episode", "resolve_chunk", "run_episode_scan",
    "run_fleet_episode_scan", "stepwise_episode", "stream_chunks",
    "DeploymentPolicy", "GuardState", "GuardedEpisodeTrace",
    "empty_counters", "gate_decision", "guardrail_counters",
    "guardrail_stats", "init_fleet_guard_state", "init_guard_state",
    "merge_counters", "rollback_decision", "FleetAgent", "FleetResult",
    "FleetTuner", "evaluate_fleet", "memory_plan", "replay_compact_trace",
    "FleetService", "ChunkFailure", "ChunkSupervisor", "HealthState",
    "ResiliencePolicy", "ResilientEpisodeTrace", "health_counters",
    "health_decision", "health_stats", "merge_health_counters",
    "init_fleet_health_state", "init_health_state", "normalize_resilience",
    "normalize_supervisor", "SharingConfig", "normalize_sharing",
    "resolve_obs_mask",
    "BatchedReplayBuffer", "ReplayBuffer", "MetricSpec", "Scalarizer",
    "normalize_state", "StepRecord", "Tuner", "TuningResult",
    "evaluate_config", "recommend_final",
]
