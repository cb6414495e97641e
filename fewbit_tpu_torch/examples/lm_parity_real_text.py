"""Real-data convergence parity: a byte-level LM on genuine English prose,
as ``examples/lm_parity_real_text.py`` does with the JAX package.

A byte-level GPT (vocab 256, 4L/128H, seq 128, batch 32) trained on the
image's common-licenses corpus (``real_text_corpus``): the labels are the
actual next bytes.  The same model, init, data order and schedule in every
configuration; only the backward's compression differs, so the
validation bits-per-byte deltas isolate the few-bit and sketched
gradients.

    python -m fewbit_tpu_torch.examples.lm_parity_real_text --steps 400 \
        [--dtype bfloat16] [--out parity.md]                     # the card
    python -m fewbit_tpu_torch.examples.lm_parity_real_text --device cpu

``--out`` appends a markdown section to a file of the caller's choosing.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import List, Optional

import torch

from fewbit_tpu_torch.examples._common import (add_device_flag, on_device,
                                               resolve_device,
                                               step_generator)
from fewbit_tpu_torch.models import GPTConfig, GPTForCausalLM
from fewbit_tpu_torch.train import (TrainConfig, byte_lm_arrays,
                                    byte_lm_batches, causal_lm_loss,
                                    make_train_step, real_text_corpus)

# (name, gelu_bits, proj_dim_ratio, sketch)
CONFIGS = [
    ("exact", None, None, "countsketch"),
    ("gelu 3-bit", 3, None, "countsketch"),
    ("randomized 20% (countsketch)", None, 0.2, "countsketch"),
    ("randomized 20% (srht)", None, 0.2, "srht"),
    ("gelu 3-bit + rand 20%", 3, 0.2, "countsketch"),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(gelu_bits, proj_dim_ratio, sketch, seq=128,
                 dtype="float32") -> GPTConfig:
    return GPTConfig(vocab_size=256, hidden_size=128, num_layers=4,
                     num_heads=4, intermediate_size=512,
                     max_position_embeddings=seq, gelu_bits=gelu_bits,
                     proj_dim_ratio=proj_dim_ratio, sketch=sketch,
                     dtype=DTYPES[dtype])


def make_data(seq=128, batch=32):
    """``(train stream, first batch, validation batches)`` in numpy; the
    first batch is drawn as the JAX script draws it to initialise its
    state, and training starts after it."""
    train_ids, val_ids = byte_lm_arrays(real_text_corpus(), seq_len=seq)
    data = byte_lm_batches(train_ids, batch, seed=7)
    n_val = (len(val_ids) // batch) * batch
    val_stream = byte_lm_batches(val_ids[:n_val], batch, seed=0)
    held = [next(val_stream) for _ in range(n_val // batch)]
    return data, next(data), held


def build(cfg: GPTConfig, steps: int, device):
    """The model, weights from seed 0, and its training step."""
    model = GPTForCausalLM(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    return model, make_train_step(
        model, TrainConfig(learning_rate=3e-4, total_steps=steps),
        loss_fn=causal_lm_loss)


def bits_per_byte(model, held, device) -> float:
    """The mean over the validation batches of the deterministic forward's
    ``causal_lm_loss``, in bits."""
    gen = torch.Generator(device=device).manual_seed(0)
    nats = 0.0
    with torch.no_grad():
        for b in held:
            b = on_device(b, device)
            logits = model(b["input_ids"], b["attention_mask"],
                           deterministic=True, sketch_generator=gen)
            nats += causal_lm_loss(logits, b["labels"]).item()
    return nats / len(held) / math.log(2.0)


def run(config_name, gelu_bits, proj_dim_ratio, sketch, steps, device,
        seq=128, batch=32, dtype="float32") -> dict:
    cfg = model_config(gelu_bits, proj_dim_ratio, sketch, seq, dtype)
    data, _, held = make_data(seq, batch)
    model, step = build(cfg, steps, device)
    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for i in range(steps):
        loss = step(on_device(next(data), device), step_generator(0, i))[
            "loss"]
    final_train = loss.item()
    bpb = bits_per_byte(model, held, device)
    seconds = time.time() - t0
    print(f"{config_name:24s} train-loss {final_train:.4f} "
          f"val-bits-per-byte {bpb:.4f}  ({seconds:.0f}s)", flush=True)
    return {"config": config_name, "final_loss": final_train,
            "bits_per_byte": bpb, "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--out", type=Path, default=None,
                        help="append a markdown section to this file")
    parser.add_argument("--dtype", default="float32", choices=tuple(DTYPES),
                        help="activation dtype")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(parser, args)

    rows = [run(name, gb, pr, sk, args.steps, device, dtype=args.dtype)
            for name, gb, pr, sk in CONFIGS]
    if args.out:
        lines = [
            "",
            "## Real-data parity: byte-level LM on real English prose",
            "",
            f"4-layer/128-hidden GPT, {args.steps} steps, byte-level LM over "
            "the OS image's common-licenses corpus (genuine English text; "
            "labels are the actual next bytes).  Identical init/data/"
            "schedule; only backward compression differs "
            "(fewbit_tpu_torch/examples/lm_parity_real_text.py).",
            "",
            "| config | final train loss | val bits-per-byte |",
            "|---|---|---|",
        ]
        for r in rows:
            lines.append(f"| {r['config']} | {r['final_loss']:.4f} | "
                         f"{r['bits_per_byte']:.4f} |")
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
        print("appended to", args.out)
    return rows


if __name__ == "__main__":
    main()
