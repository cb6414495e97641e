"""What the examples share: the ``--device`` flag, batches on the device,
the per-step generators that stand for the JAX scripts' keys, and the
mean accuracy over held batches."""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from fewbit_tpu_torch.parallel.mesh import fold_shard_generator
from fewbit_tpu_torch.train import make_eval_step


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="device to run on (default: the card)")


def resolve_device(parser: argparse.ArgumentParser,
                   args: argparse.Namespace) -> torch.device:
    """``args.device``; without a card ``cuda`` stops with a usage error,
    never quietly on the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; pass --device cpu")
    return device


def on_device(batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """A numpy batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device).long()
            for k, v in batch.items()}


def mean_accuracy(model, batches, device) -> float:
    """The eval step's accuracy, averaged over ``batches`` (numpy)."""
    evaluate = make_eval_step(model)
    return float(np.mean([evaluate(on_device(b, device))["accuracy"].item()
                          for b in batches]))


def step_generator(seed: int, i: int) -> torch.Generator:
    """Step ``i``'s generator of a run keyed ``seed``: the port's
    ``jax.random.fold_in(jax.random.key(seed), i)``.  A function of
    ``(seed, i)`` alone, so that a run restored at step ``i`` draws what
    the uninterrupted run draws."""
    return fold_shard_generator(torch.Generator().manual_seed(seed), i)
