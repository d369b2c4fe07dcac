"""AdamW built from the composable transforms (``repro/optim/adamw.py``):
``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale(-lr)`` (or
``scale_by_schedule`` of ``-lr(count)``), then ``apply_updates``.

The DDPG learner's Adam (``optim/adam.py``) is a separate, flat-state
implementation of the same op order."""

from __future__ import annotations

from typing import Callable

from repro_torch.optim.transform import GradientTransformation, \
    add_decayed_weights, chain, scale, scale_by_adam, scale_by_schedule


def _lr_transform(learning_rate) -> GradientTransformation:
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-float(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          mask: Callable | None = None) -> GradientTransformation:
    """AdamW with decoupled weight decay (applied after the moment
    rescaling and multiplied by the learning rate, as in Loshchilov &
    Hutter). Moments are float32 and updated in place."""
    return chain(scale_by_adam(b1=b1, b2=b2, eps=eps),
                 add_decayed_weights(weight_decay, mask=mask),
                 _lr_transform(learning_rate))
