from .checkpoint import CheckpointManager
from .optim import Optimizer, lrfn_schedule, make_optimizer, onecycle_schedule
from .qat import fake_quant, fake_quant_params, qat_weights
from .state import (
    TrainState,
    ctc_eval_step,
    ctc_train_step,
    make_fused_ctc_eval_step,
    make_fused_ctc_train_step,
)
from .trainer import Trainer
from .translation import (
    make_fused_translation_eval_step,
    make_fused_translation_train_step,
    make_translation_train_step,
    token_lengths,
)

__all__ = [
    "CheckpointManager",
    "Optimizer",
    "Trainer",
    "TrainState",
    "ctc_eval_step",
    "ctc_train_step",
    "fake_quant",
    "fake_quant_params",
    "lrfn_schedule",
    "make_fused_ctc_eval_step",
    "make_fused_ctc_train_step",
    "make_fused_translation_eval_step",
    "make_fused_translation_train_step",
    "make_optimizer",
    "make_translation_train_step",
    "onecycle_schedule",
    "qat_weights",
    "token_lengths",
]
