"""Training step and batch sources."""

from fewbit_tpu_torch.train.data import synthetic_glue
from fewbit_tpu_torch.train.loop import (TrainConfig, classification_loss,
                                         make_optimizer, make_schedule,
                                         make_train_step)

__all__ = ("synthetic_glue", "TrainConfig", "classification_loss",
           "make_optimizer", "make_schedule", "make_train_step")
