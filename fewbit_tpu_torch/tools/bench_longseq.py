"""Long-sequence rows on the card, as ``tools/bench_longseq.py`` gives them
for the JAX package: for a model family at a long sequence length, the
peak memory above what is held and the step time of four configurations

    vanilla            exact activations + exact linears, standard attention
    fewbit             gelu3 + sketch 20%, standard attention
    vanilla_flash      exact, flash_attention="auto"
    fewbit_flash       gelu3 + sketch 20% + flash "auto"

A configuration that does not fit on the card is an error row
(``torch.cuda.OutOfMemoryError``, the message's head); any other
exception propagates.  Each row also carries its kernel launches per step
(the launch counters of ``fewbit_tpu_torch.ops.kernels``), the steps it
took and its last loss.  The last line printed is the JSON object that
``main`` returns.

    python -m fewbit_tpu_torch.tools.bench_longseq --family gpt --batch 2 \
        --seq 2048
    python -m fewbit_tpu_torch.tools.bench_longseq --family roberta \
        --batch 4 --seq 2048
    python -m fewbit_tpu_torch.tools.bench_longseq --family gpt --batch 1 \
        --seq 4096

``--device cpu`` runs the plain versions (host times, no peak memory);
without a card and without it the tool stops with an error.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import List, Optional

import torch

LOOP_ITERS = 10
TIMED_RUNS = 3

CONFIGS = {
    "vanilla": dict(bits=None, ratio=None, flash=False),
    "fewbit": dict(bits=3, ratio=0.2, flash=False),
    "vanilla_flash": dict(bits=None, ratio=None, flash="auto"),
    "fewbit_flash": dict(bits=3, ratio=0.2, flash="auto"),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_config(family, seq, bits, ratio, flash, dtype, overrides=None):
    """The model config of one row: GPT with ``max_position_embeddings =
    seq``, RoBERTa with ``seq + 2``; ``overrides`` are config fields (a
    smaller model)."""
    from fewbit_tpu_torch.models import GPTConfig, RobertaConfig

    common = dict(gelu_bits=bits, proj_dim_ratio=ratio, sketch="countsketch",
                  dtype=dtype, flash_attention=flash, **(overrides or {}))
    if flash:  # the flash kernel applies no dropout; "auto" needs 0 to engage
        common.update(attention_dropout=0.0)
    if family == "gpt":
        return GPTConfig(max_position_embeddings=seq, **common)
    return RobertaConfig(max_position_embeddings=seq + 2, **common)


def build(family, batch, seq, bits, ratio, flash, dtype, device,
          overrides=None):
    """The model (random weights from seed 0), its training step
    (``TrainConfig(total_steps=100, learning_rate=1e-5)``) and one batch
    on ``device``: ``synthetic_lm`` and the causal LM loss for GPT,
    ``synthetic_glue`` for RoBERTa."""
    from fewbit_tpu_torch.models import (GPTForCausalLM,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                        classification_loss, make_train_step,
                                        synthetic_glue, synthetic_lm)

    cfg = model_config(family, seq, bits, ratio, flash, dtype, overrides)
    gen = torch.Generator(device=device).manual_seed(0)
    if family == "gpt":
        model = GPTForCausalLM(cfg, device=device, generator=gen)
        batch_np = next(synthetic_lm(batch, seq_len=seq,
                                     vocab_size=cfg.vocab_size))
        loss_fn = causal_lm_loss
    else:
        model = RobertaForSequenceClassification(cfg, device=device,
                                                 generator=gen)
        batch_np = next(synthetic_glue(batch, seq_len=seq,
                                       vocab_size=cfg.vocab_size))
        loss_fn = classification_loss
    data = {k: torch.from_numpy(v).to(device).long()
            for k, v in batch_np.items()}
    step = make_train_step(model, TrainConfig(total_steps=100,
                                              learning_rate=1e-5),
                           loss_fn=loss_fn)
    return model, step, data


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _row(name, args, device, overrides):
    """One configuration: a warm step (its launches), a step measured for
    its peak above what is held (the card only), then the best of
    TIMED_RUNS runs of LOOP_ITERS steps, each ending in a synchronise."""
    from fewbit_tpu_torch.ops import kernels as K

    c = CONFIGS[name]
    model, step, data = build(args.family, args.batch, args.seq, c["bits"],
                              c["ratio"], c["flash"], DTYPES[args.dtype],
                              device, overrides)
    gen = torch.Generator().manual_seed(1)
    before = K.launch_counts()
    loss = step(data, gen)["loss"].item()
    _sync(device)
    launches = {k: v - before[k] for k, v in K.launch_counts().items()
                if v > before[k]}
    row = {"config": name, "launches": launches}
    peak = None
    if device.type == "cuda":
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        loss = step(data, gen)["loss"].item()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - held
    else:
        loss = step(data, gen)["loss"].item()
    row["peak_bytes"] = peak
    steps = 2
    msg = (f"{name:<16} peak "
           f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if not args.no_time:
        best = float("inf")
        for _ in range(TIMED_RUNS):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(LOOP_ITERS):
                out = step(data, gen)
            loss = out["loss"].item()
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / LOOP_ITERS)
        steps += TIMED_RUNS * LOOP_ITERS
        row["step_ms"] = best * 1e3
        msg += f"  step {row['step_ms']:.1f} ms"
    row.update(steps=steps, loss=loss)
    log(f"{msg}  launches per step {launches or 'none'}")
    return row


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None, overrides=None) -> dict:
    """Runs the rows and prints, as the last line, the JSON object it
    returns: ``{"family", "batch", "seq", "dtype", "rows"}``.
    ``overrides`` (config fields, for a smaller model) is a test seam."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("roberta", "gpt"), default="gpt")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma list from: " + ",".join(CONFIGS))
    ap.add_argument("--no-time", action="store_true",
                    help="memory rows only (skip the timing loops)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    names = args.configs.split(",")
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(CONFIGS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to run the plain "
                 "versions on the CPU")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"device: {torch.cuda.get_device_name(device)}")
    rows = []
    for name in names:
        try:
            row = _row(name, args, device, overrides)
        except torch.cuda.OutOfMemoryError as exc:
            head = f"{type(exc).__name__}: {exc}".splitlines()[0][:160]
            row = {"config": name, "error": head}
            log(f"{name:<16} FAILED {head}")
        _free(device)
        rows.append(row)
    out = {"family": args.family, "batch": args.batch, "seq": args.seq,
           "dtype": args.dtype, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
