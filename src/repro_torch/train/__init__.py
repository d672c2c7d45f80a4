"""Training: train/eval steps with microbatch overlap, and the
fault-tolerant trainer."""

from .steps import StepConfig, make_eval_step, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["StepConfig", "Trainer", "TrainerConfig", "make_eval_step",
           "make_train_step"]
