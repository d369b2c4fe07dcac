"""Optimizers of the port: the DDPG learner's flat Adam (``adam.py``) and
the LM stack's composable transformations (``transform.py``, ``adamw.py``,
``schedule.py``), as in ``repro/optim``."""

from repro_torch.optim.adam import AdamHyper, adam_step, bias_corrections
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import constant_schedule, linear_schedule, \
    warmup_cosine_schedule
from repro_torch.optim.transform import GradientTransformation, \
    ScaleByAdamState, ScaleByScheduleState, add_decayed_weights, \
    apply_update, apply_updates, chain, clip_by_global_norm, clip_factor, \
    global_norm, scale, scale_by_adam, scale_by_schedule

__all__ = [
    "AdamHyper", "adam_step", "bias_corrections",
    "GradientTransformation", "ScaleByAdamState", "ScaleByScheduleState",
    "add_decayed_weights", "apply_update", "apply_updates", "chain",
    "clip_by_global_norm", "clip_factor", "global_norm", "scale",
    "scale_by_adam", "scale_by_schedule", "adamw", "adafactor",
    "constant_schedule", "linear_schedule", "warmup_cosine_schedule",
]
