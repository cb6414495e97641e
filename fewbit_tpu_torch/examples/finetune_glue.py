"""Fine-tune RoBERTa with few-bit compression, as
``examples/finetune_glue.py`` does with the JAX package.

Runs on synthetic MRPC-shaped data by default; ``--glue NPZ`` fine-tunes
and evaluates on a tokenized MRPC file in the schema of
:func:`fewbit_tpu_torch.train.load_tokenized_npz` (``tools/prepare_mrpc.py``
writes one on a machine with network access).  The default width is
RoBERTa-base: 12 layers, hidden 768, FFN 3072, hidden / 64 heads.

    python -m fewbit_tpu_torch.examples.finetune_glue --num-bits 3 \
        --proj-dim-ratio 0.2 --steps 50 --batch 16 [--glue mrpc.npz]
    python -m fewbit_tpu_torch.examples.finetune_glue --device cpu \
        --layers 2 --hidden 128 --steps 2

``--log-dir`` writes ``metrics.jsonl`` under ``LOG_DIR/<param>/<task>/``
(:mod:`fewbit_tpu_torch.tools.summarize_runs` tabulates such runs);
``--checkpoint-dir`` saves the final model, optimizer and schedule as
``CHECKPOINT_DIR/final`` (:func:`fewbit_tpu_torch.train.save_checkpoint`).
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
from fewbit_tpu_torch.train import (TrainConfig, batches_from_arrays,
                                    load_tokenized_npz, make_train_step,
                                    save_checkpoint, synthetic_glue)

MATMUL_CHOICES = ["gaussian", "rademacher", "dct", "dft", "countsketch",
                  "srht"]


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-bits", type=int, default=None,
                        help="few-bit GELU backward (default: exact)")
    parser.add_argument("--proj-dim-ratio", type=float, default=None,
                        help="RandomizedLinear sketch ratio (default: exact)")
    parser.add_argument("--matmul", default="gaussian",
                        choices=MATMUL_CHOICES)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--hidden", type=int, default=768)
    parser.add_argument("--checkpoint-dir", type=Path, default=None)
    parser.add_argument("--glue", type=Path, default=None, metavar="NPZ",
                        help="path to a tokenized MRPC npz (schema of "
                             "fewbit_tpu_torch.train.load_tokenized_npz). "
                             "Default: synthetic MRPC-shaped data.")
    parser.add_argument("--eval-every", type=int, default=25)
    parser.add_argument("--log-dir", type=Path, default=None,
                        help="write metrics.jsonl for this run under "
                             "LOG_DIR/<param>/<task>/ (summarise runs with "
                             "python -m fewbit_tpu_torch.tools."
                             "summarize_runs)")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    args.device = resolve_device(parser, args)
    return args


def model_config(args) -> RobertaConfig:
    return RobertaConfig(num_layers=args.layers, hidden_size=args.hidden,
                         num_heads=max(args.hidden // 64, 1),
                         intermediate_size=args.hidden * 4,
                         gelu_bits=args.num_bits,
                         proj_dim_ratio=args.proj_dim_ratio,
                         sketch=args.matmul)


def make_data(args, cfg: RobertaConfig):
    """``(train stream, first batch, validation batches or None)`` in
    numpy; the first batch is drawn as the JAX script draws it to
    initialise its state, and training starts after it."""
    eval_batches = None
    if args.glue:
        splits = load_tokenized_npz(args.glue)
        train = splits["train"]
        val = splits.get("validation")
        data = batches_from_arrays(train, args.batch)
        if val is not None:
            n_eval = (len(val["labels"]) // args.batch) * args.batch
            eval_batches = [{k: v[s:s + args.batch] for k, v in val.items()}
                            for s in range(0, n_eval, args.batch)]
        print(f"MRPC: {len(train['labels'])} train / "
              f"{len(val['labels']) if val else 0} validation examples")
    else:
        data = synthetic_glue(args.batch, seq_len=args.seq,
                              vocab_size=cfg.vocab_size)
    return data, next(data), eval_batches


def build(args, cfg: RobertaConfig):
    """The model, weights from seed 0, and its training step."""
    model = RobertaForSequenceClassification(
        cfg, device=args.device,
        generator=torch.Generator(device=args.device).manual_seed(0))
    return model, make_train_step(model, TrainConfig(
        learning_rate=args.lr, total_steps=args.steps))


def accuracy(model, args, batch0, eval_batches) -> float:
    """The validation accuracy, or without validation batches the
    accuracy on the first batch, as the JAX script holds it out."""
    return mean_accuracy(model, eval_batches or [batch0], args.device)


def finetune(args) -> dict:
    """The run of :func:`main`: its rows, and the model, step and data
    stream as they stand after it (so that a caller can take the next
    step)."""
    from fewbit_tpu_torch.metrics import MetricsLogger

    cfg = model_config(args)
    data, batch0, eval_batches = make_data(args, cfg)
    model, step = build(args, cfg)
    which = "val" if eval_batches is not None else "holdout"

    logger = None
    if args.log_dir:
        param = (f"gelu{args.num_bits or 0}-"
                 f"rand{int(100 * (args.proj_dim_ratio or 0))}%")
        task = "mrpc" if args.glue else "synthetic"
        logger = MetricsLogger(args.log_dir / param / task,
                               task=task, param=param)

    print(f"config: {cfg.num_layers}L/{cfg.hidden_size}H gelu_bits="
          f"{cfg.gelu_bits} proj_dim_ratio={cfg.proj_dim_ratio}")
    rows = []
    t0 = time.time()
    for i in range(args.steps):
        metrics = step(on_device(next(data), args.device),
                       step_generator(0, i))
        if logger:
            logger.log(i + 1, **{"train/loss": metrics["loss"].item()})
        if (i + 1) % args.eval_every == 0 or i == 0:
            acc = accuracy(model, args, batch0, eval_batches)
            loss = metrics["loss"].item()
            if logger:
                logger.log(i + 1, **{"eval/accuracy": acc})
            print(f"step {i+1:4d}  loss {loss:.4f}  "
                  f"{which} acc {acc:.3f}  ({time.time()-t0:.1f}s)")
            rows.append({"step": i + 1, "loss": loss, which: acc,
                         "seconds": time.time() - t0})
    final_acc = accuracy(model, args, batch0, eval_batches)
    if logger:
        logger.log(args.steps, **{"eval/accuracy": final_acc})
        logger.close()
    print(f"final {which} accuracy: {final_acc:.4f}")
    rows.append({"step": args.steps, "final": True, which: final_acc})

    if args.checkpoint_dir:
        args.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        save_checkpoint(args.checkpoint_dir / "final", model, step)
        print("checkpoint saved to", args.checkpoint_dir / "final")
    return {"rows": rows, "model": model, "step": step, "data": data}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return finetune(parse_args(argv))["rows"]


if __name__ == "__main__":
    main()
