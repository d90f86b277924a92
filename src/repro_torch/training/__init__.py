"""Training substrate: optimizer, gradient compression, checkpointing and
the train loop (`repro/training`), over trees of tensors."""

from .checkpoint import CheckpointConfig, CheckpointManager
from .optimizer import (OptimizerConfig, adamw_update, global_norm,
                        init_opt_state, schedule_lr)
from .train_loop import TrainLog, TrainLoopConfig, make_train_step, run

__all__ = ["CheckpointConfig", "CheckpointManager", "OptimizerConfig",
           "adamw_update", "global_norm", "init_opt_state", "schedule_lr",
           "TrainLog", "TrainLoopConfig", "make_train_step", "run"]
