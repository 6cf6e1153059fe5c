from repro_torch.train.optimizer import adamw_init, adamw_update, lr_schedule
from repro_torch.train.step import TrainState, make_train_step

__all__ = [
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "make_train_step",
    "TrainState",
]
