from .checkpoint import CheckpointManager
from .optim import Optimizer, lrfn_schedule, make_optimizer, onecycle_schedule
from .state import (
    TrainState,
    ctc_eval_step,
    ctc_train_step,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
)
from .trainer import Trainer

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "Trainer",
    "TrainState",
    "ctc_eval_step",
    "ctc_train_step",
    "lrfn_schedule",
    "make_fused_ctc_eval_step",
    "make_fused_ctc_train_step",
    "make_optimizer",
    "onecycle_schedule",
]
