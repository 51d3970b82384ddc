"""Training of the port: the train step, its optimizers, the training run
(``ModelTrainer``: epochs, validation, checkpoints, resume, watch
histograms), checkpoints and validation metrics (counterparts of the JAX
package's ``train/``)."""
from .optim import (
    clip_by_global_norm_,
    get_learning_rate,
    get_optimizer,
    global_norm,
    multistep_lr,
    set_learning_rate,
)
from .checkpoint import CheckpointManager, best_or_latest_params, restore_params
from .trainer import (
    ModelTrainer,
    make_eval_step,
    make_train_step,
    make_watch_step,
    normalize_u8,
)

__all__ = [
    "CheckpointManager",
    "ModelTrainer",
    "best_or_latest_params",
    "clip_by_global_norm_",
    "get_learning_rate",
    "get_optimizer",
    "global_norm",
    "make_eval_step",
    "make_train_step",
    "make_watch_step",
    "multistep_lr",
    "normalize_u8",
    "restore_params",
    "set_learning_rate",
]
