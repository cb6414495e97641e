"""Real-prose classification parity: exact against few-bit and sketched
fine-tuning, as ``examples/classification_parity_real_text.py`` does with
the JAX package.

On the real English prose of the image's common-licenses corpus:

* ``--task doc`` (default): which license text a genuine segment came
  from (``real_doc_arrays``), through the pooled ``<s>`` head and a
  cross-entropy fine-tune, the path MRPC takes;
* ``--task pair``: the MRPC-shaped segment-pair task
  (``real_pair_arrays(min_segment=64)``), which a small model trained from
  scratch does not learn (see the JAX script);
* ``--pretrain N``: N steps of an in-corpus denoising MLM of the shared
  exact encoder (:func:`pretrain_backbone`) before the fine-tunes.

The same model, init, data and schedule in every configuration; only the
backward's compression differs.  ``--seeds`` runs each configuration from
that many seeds and reports the mean and standard deviation of the
validation accuracy as a markdown table on stdout.

    python -m fewbit_tpu_torch.examples.classification_parity_real_text \
        --steps 1200                                             # the card
    python -m fewbit_tpu_torch.examples.classification_parity_real_text \
        --device cpu --steps 2
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from fewbit_tpu_torch.examples._common import (add_device_flag,
                                               mean_accuracy, on_device,
                                               resolve_device,
                                               step_generator)
from fewbit_tpu_torch.models import (RobertaConfig,
                                     RobertaForSequenceClassification,
                                     RobertaModel)
from fewbit_tpu_torch.models.roberta import (_dense_pairs, encoder_pairs,
                                             model_device)
from fewbit_tpu_torch.modules.linear import Dense
from fewbit_tpu_torch.train import (TrainConfig, batches_from_arrays,
                                    make_train_step, real_doc_arrays,
                                    real_pair_arrays, real_text_corpus)

SEQ = 128
VOCAB = 259  # <s>=0 pad=1 </s>=2, byte b -> b + 3
# (name, gelu_bits, proj_dim_ratio, sketch)
CONFIGS = [
    ("exact", None, None, None),
    ("gelu 3-bit", 3, None, None),
    ("randomized 20% (countsketch)", None, 0.2, "countsketch"),
    ("gelu 3-bit + rand 20%", 3, 0.2, "countsketch"),
]
MASK_RATE = 0.15


def model_config(num_labels, gelu_bits=None, proj_dim_ratio=None,
                 sketch="countsketch") -> RobertaConfig:
    # fused_ffn=False keeps one parameter tree across all configurations
    # (`intermediate` and `ffn_output`), so that one pretrained encoder fits
    # every one of them.
    return RobertaConfig(vocab_size=VOCAB, hidden_size=128, num_layers=4,
                         num_heads=4, intermediate_size=512,
                         max_position_embeddings=SEQ + 2,
                         num_labels=num_labels, pad_token_id=1,
                         gelu_bits=gelu_bits,
                         proj_dim_ratio=proj_dim_ratio, sketch=sketch,
                         fused_ffn=False)


def build(cfg: RobertaConfig, steps: int, device, lr=3e-4, seed=0,
          backbone=None):
    """The model, weights from ``seed``, its encoder replaced by
    ``backbone`` (a ``RobertaModel`` state dict) when given, and its
    training step.  The head stays as the seed drew it."""
    model = RobertaForSequenceClassification(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    if backbone is not None:
        model.roberta.load_state_dict(backbone)
    return model, make_train_step(model, TrainConfig(learning_rate=lr,
                                                     total_steps=steps))


def train_stream(train_arrays, batch, seed=0):
    """``(stream, first batch)``: the shuffled epochs of a seed's run; the
    first batch is drawn as the JAX script draws it to initialise its
    state, and training starts after it."""
    stream = batches_from_arrays(train_arrays, batch, seed=7 + seed)
    return stream, next(stream)


def val_batches(val_arrays, batch):
    n_val = (len(val_arrays["labels"]) // batch) * batch
    return [{k: v[i:i + batch] for k, v in val_arrays.items()}
            for i in range(0, n_val, batch)]


def train_one(config_name, data, num_labels, gelu_bits, proj_dim_ratio,
              sketch, steps, device, batch=32, lr=3e-4, seed=0,
              backbone=None):
    train_arrays, val_arrays = data
    cfg = model_config(num_labels, gelu_bits, proj_dim_ratio,
                       sketch or "countsketch")
    stream, _ = train_stream(train_arrays, batch, seed)
    model, step = build(cfg, steps, device, lr, seed, backbone)
    held = val_batches(val_arrays, batch)

    loss = torch.tensor(float("nan"))
    t0 = time.time()
    for i in range(steps):
        loss = step(on_device(next(stream), device),
                    step_generator(seed, i))["loss"]
    final_train = loss.item()
    acc = mean_accuracy(model, held, device)
    print(f"{config_name:32s} seed {seed} train-loss {final_train:.4f} "
          f"val-accuracy {acc:.4f}  ({time.time()-t0:.0f}s)", flush=True)
    return final_train, acc


# ---------------------------------------------------------------------------
# The in-corpus denoising MLM that pretrains the shared encoder.
# ---------------------------------------------------------------------------


class ByteMLM(nn.Module):
    """The exact encoder (``roberta``) and a byte head (``lm_head``), the
    JAX script's ``ByteMLM``."""

    def __init__(self, cfg: RobertaConfig, device=None, generator=None):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.roberta = RobertaModel(cfg, device, generator)
        self.lm_head = Dense(cfg.hidden_size, VOCAB, cfg.dtype,
                             device=device, generator=generator)

    def forward(self, ids, deterministic: bool = True,
                dropout_generator=None):
        h = self.roberta(ids, torch.ones_like(ids),
                         deterministic=deterministic,
                         dropout_generator=dropout_generator)
        return self.lm_head(h)

    def flax_param_pairs(self, p, tp=(0, 1)):
        yield from encoder_pairs(self.roberta, p["roberta"], tp)
        yield from _dense_pairs(self.lm_head, p["lm_head"], "lm_head")


def mlm_windows(text: bytes) -> np.ndarray:
    """The corpus cut into ``SEQ - 1``-byte windows, bytes shifted by 3,
    each after ``<s>``: int32 ``(n, SEQ)``."""
    # Widen before the +3 shift: a uint8 + 3 wraps bytes >= 253 onto the
    # special tokens.
    arr = np.frombuffer(text, dtype=np.uint8).astype(np.int32)
    n_win = (len(arr) - 1) // (SEQ - 1)
    windows = np.stack([arr[i * (SEQ - 1):(i + 1) * (SEQ - 1)] + 3
                        for i in range(n_win)])
    return np.concatenate([np.zeros((n_win, 1), np.int32), windows], axis=1)


def mlm_batches(windows: np.ndarray, batch: int, seed: int = 0):
    """Endless ``(ids, corrupt, originals)``: ``batch`` windows drawn with
    replacement, 15% of their positions (never ``<s>``) replaced by random
    byte tokens; the draws of the JAX script's ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(0, len(windows), size=batch)
        ids = windows[idx].copy()
        originals = ids.copy()
        corrupt = rng.rand(batch, SEQ) < MASK_RATE
        corrupt[:, 0] = False
        ids[corrupt] = rng.randint(3, VOCAB, size=int(corrupt.sum()))
        yield ids, corrupt, originals


def mlm_loss(logits, corrupt, originals) -> torch.Tensor:
    """Cross entropy at the corrupted positions only, their mean."""
    per = TF.cross_entropy(logits.float().flatten(0, -2),
                           originals.long().flatten(), reduction="none")
    m = corrupt.float().flatten()
    return (per * m).sum() / m.sum().clamp_min(1)


def mlm_optimizer(params, lr: float, steps: int):
    """``(optimizer, scheduler)``: optax's ``adamw(linear_schedule(lr, 0,
    steps), b1=0.9, b2=0.98, weight_decay=0.01)``, decay on every
    parameter, eps 1e-8, the rate falling linearly from ``lr`` to 0."""
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.98), eps=1e-8,
                            weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: 1.0 - min(count, steps) / steps if steps else 1.0)
    return opt, sched


def pretrain_backbone(steps, device, batch=32, lr=3e-4, seed=0):
    """A short in-corpus denoising MLM of the exact encoder: 15% of byte
    positions replaced by random byte tokens, the original byte predicted
    there.  Returns the encoder's state dict (a copy).

    The raw windows include text that lands on the validation side of the
    pair split; the pair labels are never seen, so the comparison across
    configurations stays fair (all share the encoder), but the pair task's
    accuracy is in-domain."""
    cfg = model_config(num_labels=2)  # the exact encoder
    windows = mlm_windows(real_text_corpus())
    model = ByteMLM(cfg, device,
                    torch.Generator(device=device).manual_seed(seed))
    opt, sched = mlm_optimizer(model.parameters(), lr, steps)
    corruptions = mlm_batches(windows, batch, seed)

    t0 = time.time()
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        ids, corrupt, originals = (torch.from_numpy(a).to(device)
                                   for a in next(corruptions))
        seed_i = int(torch.randint(0, 2 ** 62, (1,),
                                   generator=step_generator(1000 + seed, i)))
        dropout_gen = torch.Generator(device=device).manual_seed(seed_i)
        loss = mlm_loss(model(ids.long(), deterministic=False,
                              dropout_generator=dropout_gen),
                        corrupt, originals)
        loss.backward()
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        if (i + 1) % 200 == 0:
            print(f"  pretrain step {i + 1}/{steps} mlm-loss "
                  f"{loss.item():.4f} ({time.time() - t0:.0f}s)", flush=True)
    print(f"pretrain done: {steps} steps, final mlm-loss {loss.item():.4f} "
          f"(chance {np.log(256):.2f})", flush=True)
    return {k: v.detach().clone()
            for k, v in model.roberta.state_dict().items()}


def task_data(task: str):
    """``(train, val, classes)`` of ``--task``."""
    if task == "doc":
        return real_doc_arrays()
    train_arrays, val_arrays = real_pair_arrays(min_segment=64)
    return train_arrays, val_arrays, 2


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=("doc", "pair"), default="doc")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per configuration (mean±std reported)")
    ap.add_argument("--pretrain", type=int, default=0,
                    help="in-corpus denoising-MLM pretrain steps for the "
                         "shared (exact) encoder before fine-tuning")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)

    train_arrays, val_arrays, n_cls = task_data(args.task)
    data = (train_arrays, val_arrays)
    print(f"{args.task} dataset: train {len(train_arrays['labels'])}, "
          f"val {len(val_arrays['labels'])}, {n_cls} classes "
          f"(chance {1.0 / n_cls:.3f})", flush=True)

    backbone = None
    if args.pretrain:
        print(f"pretraining shared encoder: {args.pretrain} MLM steps",
              flush=True)
        backbone = pretrain_backbone(args.pretrain, device, batch=args.batch)

    rows = []
    for name, bits, ratio, sketch in CONFIGS:
        losses, accs = [], []
        for seed in range(args.seeds):
            loss, acc = train_one(name, data, n_cls, bits, ratio, sketch,
                                  args.steps, device, batch=args.batch,
                                  seed=seed, backbone=backbone)
            losses.append(loss)
            accs.append(acc)
        rows.append({"config": name, "final_loss": float(np.mean(losses)),
                     "accuracy": float(np.mean(accs)),
                     "accuracy_std": float(np.std(accs)), "seeds": len(accs)})

    print(f"\n| config | final train loss (mean) | val accuracy "
          f"mean±std over {args.seeds} seeds (chance {1.0 / n_cls:.3f}) |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r['config']} | {r['final_loss']:.4f} | "
              f"{r['accuracy']:.3f} ± {r['accuracy_std']:.3f} |")
    return rows


if __name__ == "__main__":
    main()
