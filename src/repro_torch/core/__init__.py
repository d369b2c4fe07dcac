from repro_torch.core.action_mapping import ParamSpace, ParamSpec
from repro_torch.core.agent import MagpieAgent, lhs_warmup_plan
from repro_torch.core.ddpg import DDPGConfig, DDPGState, ddpg_init, \
    fleet_act, fleet_init, fleet_learn_scan
from repro_torch.core.episode import last_fleet_run_stats, \
    live_device_bytes, precompile_fleet_episode, resolve_chunk, \
    run_fleet_episode_scan, stream_chunks
from repro_torch.core.fleet import FleetAgent, FleetResult, FleetTuner, \
    evaluate_fleet, memory_plan, replay_compact_trace
from repro_torch.core.replay_buffer import BatchedReplayBuffer, ReplayBuffer
from repro_torch.core.scalarization import MetricSpec, Scalarizer, \
    normalize_state
from repro_torch.core.service import FleetService
from repro_torch.core.tuner import StepRecord, Tuner, TuningResult, \
    evaluate_config, recommend_final

__all__ = [
    "ParamSpace", "ParamSpec", "MagpieAgent", "lhs_warmup_plan",
    "DDPGConfig", "DDPGState", "ddpg_init", "fleet_act", "fleet_init",
    "fleet_learn_scan", "last_fleet_run_stats", "live_device_bytes",
    "precompile_fleet_episode", "resolve_chunk", "run_fleet_episode_scan",
    "stream_chunks", "FleetAgent", "FleetResult", "FleetTuner",
    "evaluate_fleet", "memory_plan", "replay_compact_trace", "FleetService",
    "BatchedReplayBuffer", "ReplayBuffer", "MetricSpec", "Scalarizer",
    "normalize_state", "StepRecord", "Tuner", "TuningResult",
    "evaluate_config", "recommend_final",
]
