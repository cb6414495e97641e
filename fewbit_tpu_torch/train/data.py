"""Batch sources: ``synthetic_glue`` and ``synthetic_lm`` as in
``fewbit_tpu/train/data.py``.

numpy only, with the same draws in the same order, so that one seed gives
the JAX package and the port the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ("synthetic_glue", "synthetic_lm")


def synthetic_glue(batch_size: int,
                   seq_len: int = 128,
                   vocab_size: int = 50265,
                   pad_token_id: int = 1,
                   num_labels: int = 2,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless MRPC-shaped batches with learnable labels (a parity of a few
    token buckets)."""
    rng = np.random.RandomState(seed)
    while True:
        lengths = rng.randint(seq_len // 2, seq_len + 1, size=batch_size)
        ids = rng.randint(10, vocab_size, size=(batch_size, seq_len))
        mask = np.zeros((batch_size, seq_len), np.int32)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1
            ids[i, n:] = pad_token_id
        ids[:, 0] = 0  # <s>
        signal = (ids[:, 1:8].sum(axis=1) // 7) % num_labels
        yield {"input_ids": ids.astype(np.int32),
               "attention_mask": mask,
               "labels": signal.astype(np.int32)}


def synthetic_lm(batch_size: int,
                 seq_len: int = 128,
                 vocab_size: int = 50257,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless causal-LM batches with learnable structure (each token is a
    noisy function of its predecessor), labels pre-shifted for
    :func:`fewbit_tpu_torch.train.causal_lm_loss` (-100 = ignored)."""
    rng = np.random.RandomState(seed)
    while True:
        ids = np.empty((batch_size, seq_len), np.int64)
        ids[:, 0] = rng.randint(0, vocab_size, size=batch_size)
        for t in range(1, seq_len):
            follow = (ids[:, t - 1] * 31 + 7) % vocab_size
            noise = rng.randint(0, vocab_size, size=batch_size)
            take = rng.rand(batch_size) < 0.75
            ids[:, t] = np.where(take, follow, noise)
        labels = np.full_like(ids, -100)
        labels[:, :-1] = ids[:, 1:]
        yield {"input_ids": ids.astype(np.int32),
               "attention_mask": np.ones_like(ids, np.int32),
               "labels": labels.astype(np.int32)}
