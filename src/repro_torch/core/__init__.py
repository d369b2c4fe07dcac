from repro_torch.core.action_mapping import ParamSpace, ParamSpec
from repro_torch.core.agent import MagpieAgent, lhs_warmup_plan
from repro_torch.core.ddpg import DDPGConfig, DDPGState, ddpg_init
from repro_torch.core.replay_buffer import ReplayBuffer
from repro_torch.core.scalarization import MetricSpec, Scalarizer, \
    normalize_state
from repro_torch.core.tuner import StepRecord, Tuner, TuningResult, \
    evaluate_config, recommend_final

__all__ = [
    "ParamSpace", "ParamSpec", "MagpieAgent", "lhs_warmup_plan",
    "DDPGConfig", "DDPGState", "ddpg_init", "ReplayBuffer", "MetricSpec",
    "Scalarizer", "normalize_state", "StepRecord", "Tuner", "TuningResult",
    "evaluate_config", "recommend_final",
]
