"""Training step, losses and batch sources."""

from fewbit_tpu_torch.train.data import (batches_from_arrays, byte_lm_arrays,
                                         byte_lm_batches, load_glue,
                                         load_token_archive,
                                         load_tokenized_npz, real_doc_arrays,
                                         real_pair_arrays, real_text_corpus,
                                         real_text_documents,
                                         save_token_archive, synthetic_glue,
                                         synthetic_lm)
from fewbit_tpu_torch.train.loop import (TrainConfig, causal_lm_loss,
                                         classification_loss, make_eval_step,
                                         make_optimizer, make_schedule,
                                         make_train_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ("synthetic_glue", "synthetic_lm", "load_tokenized_npz",
           "batches_from_arrays", "real_text_corpus", "real_text_documents",
           "byte_lm_arrays", "byte_lm_batches", "real_pair_arrays",
           "real_doc_arrays", "save_token_archive", "load_token_archive",
           "load_glue", "TrainConfig", "causal_lm_loss",
           "classification_loss", "make_eval_step", "make_optimizer",
           "make_schedule", "make_train_step", "restore_checkpoint",
           "save_checkpoint")
