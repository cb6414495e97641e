"""Training step, losses and batch sources."""

from fewbit_tpu_torch.train.data import synthetic_glue, synthetic_lm
from fewbit_tpu_torch.train.loop import (TrainConfig, causal_lm_loss,
                                         classification_loss, make_eval_step,
                                         make_optimizer, make_schedule,
                                         make_train_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ("synthetic_glue", "synthetic_lm", "TrainConfig", "causal_lm_loss",
           "classification_loss", "make_eval_step", "make_optimizer",
           "make_schedule", "make_train_step", "restore_checkpoint",
           "save_checkpoint")
