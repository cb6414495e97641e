"""Convergence parity: exact against few-bit training on a learnable task,
as ``examples/convergence_parity.py`` does with the JAX package.

The same model, data, init and schedule in every configuration; only the
backward's compression differs.  RoBERTa 4L/128H on ``synthetic_glue``;
prints the final training loss and the holdout accuracy of each
configuration and, with ``--out``, writes them as a markdown table.

    python -m fewbit_tpu_torch.examples.convergence_parity --steps 300 \
        --out parity.md                                          # the card
    python -m fewbit_tpu_torch.examples.convergence_parity --device cpu

The loss is recorded every ``LOG_EVERY`` steps, as in the JAX script, and
the final loss is the last step's: the JAX script reads its last record,
which does not exist below ``LOG_EVERY`` steps (F-9 in ``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import torch

from fewbit_tpu_torch.examples._common import (add_device_flag,
                                               mean_accuracy, on_device,
                                               resolve_device,
                                               step_generator)
from fewbit_tpu_torch.models import (RobertaConfig,
                                     RobertaForSequenceClassification)
from fewbit_tpu_torch.train import (TrainConfig, make_train_step,
                                    synthetic_glue)

# (name, gelu_bits, proj_dim_ratio)
CONFIGS = [
    ("exact", None, None),
    ("gelu 3-bit", 3, None),
    ("gelu 1-bit", 1, None),
    ("randomized 20%", None, 0.2),
    ("gelu 3-bit + rand 20%", 3, 0.2),
]
BATCH, SEQ = 32, 64
LOG_EVERY = 50


def model_config(gelu_bits, proj_dim_ratio) -> RobertaConfig:
    return RobertaConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                         num_heads=4, intermediate_size=512,
                         max_position_embeddings=130, gelu_bits=gelu_bits,
                         proj_dim_ratio=proj_dim_ratio, sketch="countsketch")


def make_data(cfg: RobertaConfig, eval_batches: int = 8):
    """``(train stream, first batch, holdout batches)`` in numpy; the first
    batch is drawn as the JAX script draws it to initialise its state, and
    training starts after it."""
    data = synthetic_glue(BATCH, seq_len=SEQ, vocab_size=cfg.vocab_size,
                          seed=1)
    held = [next(synthetic_glue(BATCH, seq_len=SEQ,
                                vocab_size=cfg.vocab_size, seed=999 + i))
            for i in range(eval_batches)]
    return data, next(data), held


def build(cfg: RobertaConfig, steps: int, device):
    """The model, weights from seed 0, and its training step."""
    model = RobertaForSequenceClassification(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    return model, make_train_step(model, TrainConfig(learning_rate=3e-4,
                                                     total_steps=steps))


def run(config_name, gelu_bits, proj_dim_ratio, steps, device,
        eval_batches=8) -> dict:
    cfg = model_config(gelu_bits, proj_dim_ratio)
    data, _, held = make_data(cfg, eval_batches)
    model, step = build(cfg, steps, device)
    losses = []
    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for i in range(steps):
        loss = step(on_device(next(data), device), step_generator(0, i))[
            "loss"]
        if (i + 1) % LOG_EVERY == 0:
            losses.append(loss.item())
    final = loss.item()
    acc = mean_accuracy(model, held, device)
    seconds = time.time() - t0
    print(f"{config_name:24s} final-loss {final:.4f} "
          f"holdout-acc {acc:.3f}  ({seconds:.0f}s)", flush=True)
    return {"config": config_name, "losses": losses, "final_loss": final,
            "accuracy": acc, "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--out", type=Path, default=None)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(parser, args)

    rows = [run(name, gb, pr, args.steps, device)
            for name, gb, pr in CONFIGS]
    if args.out:
        lines = [
            "# Convergence parity (exact vs few-bit backward)",
            "",
            f"4-layer/128-hidden RoBERTa on a learnable synthetic GLUE-style "
            f"task, {args.steps} steps, identical init/data/schedule; only "
            "the backward compression differs (see "
            "fewbit_tpu_torch/examples/convergence_parity.py).",
            "",
            "| config | final train loss | holdout accuracy |",
            "|---|---|---|",
        ]
        for r in rows:
            lines.append(f"| {r['config']} | {r['final_loss']:.4f} | "
                         f"{r['accuracy']:.3f} |")
        args.out.write_text("\n".join(lines) + "\n")
        print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()
