"""Training substrate: optimizers, schedules, train step, trainer loop."""

from repro_torch.train.optimizer import (
    AdamWState,
    OptConfig,
    init_opt_state,
    lr_schedule,
    update,
)
from repro_torch.train.train_step import TrainConfig, make_loss_fn, make_train_step

__all__ = [
    "AdamWState",
    "OptConfig",
    "TrainConfig",
    "init_opt_state",
    "lr_schedule",
    "make_loss_fn",
    "make_train_step",
    "update",
]
