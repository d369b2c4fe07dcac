"""Training and serving steps of the port, and the training loop."""

from repro_torch.training.losses import cross_entropy
from repro_torch.training.steps import TrainConfig, make_decode_step, \
    make_grad_fn, make_prefill_step, make_train_step
from repro_torch.training.trainer import StragglerAbort, Trainer, \
    TrainerConfig

__all__ = [
    "cross_entropy", "TrainConfig", "make_grad_fn", "make_train_step",
    "make_prefill_step", "make_decode_step", "StragglerAbort", "Trainer",
    "TrainerConfig",
]
