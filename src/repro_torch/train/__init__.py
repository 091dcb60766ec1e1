"""Training: AdamW, the step factory and the trainer."""

from .optimizer import (OptimizerConfig, adamw_init, adamw_update,
                        global_norm, warmup_cosine, zero_moment_defs)
from .trainer import (Trainer, make_eval_step, make_train_step,
                      make_train_step_reduce_once)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine", "zero_moment_defs", "Trainer", "make_eval_step",
           "make_train_step", "make_train_step_reduce_once"]
