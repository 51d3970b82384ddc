"""Training of the port: the train step and its optimizers (counterparts of
the JAX package's ``train/trainer.py`` ``make_train_step`` and
``train/optim.py``)."""
from .optim import (
    clip_by_global_norm_,
    get_learning_rate,
    get_optimizer,
    global_norm,
    multistep_lr,
    set_learning_rate,
)
from .trainer import make_train_step, normalize_u8

__all__ = [
    "clip_by_global_norm_",
    "get_learning_rate",
    "get_optimizer",
    "global_norm",
    "make_train_step",
    "multistep_lr",
    "normalize_u8",
    "set_learning_rate",
]
