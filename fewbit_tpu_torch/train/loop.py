"""Training and eval steps, optimizer, schedule, loss and checkpoints, as
in ``fewbit_tpu/train/loop.py``; the training step also under data
parallelism (``dp_group``).

AdamW with betas (0.9, 0.98), eps 1e-6 and weight decay 0.1 on all
parameters, and a linear warmup (6% of the steps, from 0) followed by a
linear decay to 0, the same recipe and the same per-step learning rates as
the JAX package's optax chain.  Checkpoints hold the model, the optimizer,
the schedule and the step count (``torch.save``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from fewbit_tpu_torch.parallel.mesh import fold_shard_generator
from fewbit_tpu_torch.parallel.tp import tp_param_spec

__all__ = ("TrainConfig", "make_schedule", "make_optimizer",
           "classification_loss", "causal_lm_loss", "clip_by_global_norm_",
           "make_train_step",
           "make_eval_step", "save_checkpoint", "restore_checkpoint")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    warmup_ratio: float = 0.06
    total_steps: int = 1000
    max_grad_norm: Optional[float] = None


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Learning rate at optimizer step ``count`` (0 at step 0)."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 1)
    decay = cfg.total_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return cfg.learning_rate * count / warmup
        if decay <= 0:
            return cfg.learning_rate
        frac = min(count - warmup, decay) / decay
        return cfg.learning_rate * (1.0 - frac)

    return schedule


def make_optimizer(cfg: TrainConfig, params):
    """``(optimizer, scheduler)``: AdamW on ``params`` and a ``LambdaLR``
    that follows :func:`make_schedule`."""
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
    schedule = make_schedule(cfg)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / cfg.learning_rate)
    return opt, sched


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    return TF.cross_entropy(logits.float(), labels.long())


def _causal_lm_sum_count(logits: torch.Tensor, labels: torch.Tensor):
    """(loss sum over the valid tokens, their count): what the dp step
    combines to weight the shards by their valid tokens."""
    valid = labels >= 0
    per_tok = TF.cross_entropy(logits.float().flatten(0, -2),
                               labels.clamp_min(0).long().flatten(),
                               reduction="none")
    return (per_tok * valid.flatten()).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy, token-weighted: ``labels`` are pre-shifted
    (the label at position t is token t + 1) and negative labels are
    masked out."""
    total, count = _causal_lm_sum_count(logits, labels)
    return total / count.clamp_min(1)


# Marks the loss as token-weighted: under dp the step divides each shard's
# loss sum by the valid tokens of all shards, not a mean of shard means,
# which is biased when the shards hold unequal valid counts.
causal_lm_loss.sum_count = _causal_lm_sum_count


def clip_by_global_norm_(params, max_norm: float, tp_group=None,
                         split=None) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    where their global 2-norm is at least ``max_norm``, as
    ``optax.clip_by_global_norm`` does (each gradient ``g / norm *
    max_norm``; no epsilon).  Returns the norm, without a host sync.

    With ``tp_group`` the parameters are one rank's slice of a tp model,
    and ``split`` flags, parameter by parameter, those split over the
    group: the norm is the unsharded model's, the squares of the split
    gradients summed over the group's ranks and those of the replicated
    ones (equal on every rank) counted once, so that every rank scales by
    the same factor."""
    params = list(params)
    split = split or [False] * len(params)
    pairs = [(p.grad, s) for p, s in zip(params, split)
             if p.grad is not None]
    grads = [g for g, _ in pairs]
    if tp_group is None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    else:
        zero = torch.zeros((), device=grads[0].device)
        sharded, replicated = (sum(((g.float() ** 2).sum()
                                    for g, s in pairs if s == on), zero)
                               for on in (True, False))
        dist.all_reduce(sharded, group=tp_group)
        norm = torch.sqrt(sharded + replicated)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def make_train_step(model: torch.nn.Module, cfg: TrainConfig,
                    loss_fn: Callable = classification_loss,
                    dp_group=None) -> Callable:
    """Build ``step(batch, generator) -> {"loss": tensor}``, with the
    gradients' global norm before the clip under ``"grad_norm"`` where
    ``cfg.max_grad_norm`` is set.

    ``batch`` holds ``input_ids``, ``attention_mask`` and ``labels`` on the
    model's device.  ``generator`` (a CPU ``torch.Generator``) seeds two
    fresh device generators per step, one for dropout and one for the
    sketch signs, as the JAX step splits its key.

    With ``dp_group`` (``model`` in ``DistributedDataParallel`` over it,
    :func:`fewbit_tpu_torch.parallel.data_parallel_step`) each dp rank
    seeds from ``fold_shard_generator(generator, dp rank)``, as the JAX
    step folds the dp index into its key, and the reported loss is the
    mean over dp.  A token-weighted loss (one with ``sum_count``, as
    :func:`causal_lm_loss`) divides each rank's loss sum by the valid
    tokens of all ranks, times the dp size, so that the gradient average
    is ``sum_i s_i / n_total``.

    ``step.loss_and_grads(batch, generator)`` is the step without the
    update: it leaves the gradients on the parameters and returns the
    loss.  ``step.clip_grads()`` is the step's clip by
    ``cfg.max_grad_norm`` on those gradients (it returns the norm).  On a
    tp slice (a model with a ``tp_group``) the norm is the unsharded
    model's (:func:`clip_by_global_norm_`); under dp DDP has already
    averaged the gradients.
    """
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    opt, sched = make_optimizer(cfg, params)
    device = params[0].device
    # A tp slice's group, from its modules (None off tp).
    tp_group = next((m.tp_group for m in model.modules()
                     if getattr(m, "tp_group", None) is not None), None)
    split = [tp_param_spec(n, p).count("tp") > 0 for n, p in named]
    sum_count = getattr(loss_fn, "sum_count", None)

    def loss_and_grads(batch: Dict[str, torch.Tensor],
                       generator: torch.Generator) -> torch.Tensor:
        if dp_group is not None:
            generator = fold_shard_generator(generator,
                                             dist.get_rank(dp_group))
        seeds = torch.randint(0, 2 ** 62, (2,), generator=generator)
        dropout_gen = torch.Generator(device=device)
        dropout_gen.manual_seed(int(seeds[0]))
        sketch_gen = torch.Generator(device=device)
        sketch_gen.manual_seed(int(seeds[1]))
        logits = model(batch["input_ids"], batch.get("attention_mask"),
                       deterministic=False, dropout_generator=dropout_gen,
                       sketch_generator=sketch_gen)
        if dp_group is None:
            loss = loss_fn(logits, batch["labels"])
            loss.backward()
            return loss.detach()
        d = dist.get_world_size(dp_group)
        if sum_count is not None:
            total, count = sum_count(logits, batch["labels"])
            dist.all_reduce(count, group=dp_group)
            loss = total * d / count.clamp_min(1)
        else:
            loss = loss_fn(logits, batch["labels"])
        loss.backward()
        reported = loss.detach().clone()
        dist.all_reduce(reported, group=dp_group)
        return reported / d

    def clip_grads() -> torch.Tensor:
        return clip_by_global_norm_(params, cfg.max_grad_norm, tp_group,
                                    split)

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        loss = loss_and_grads(batch, generator)
        out = {"loss": loss}
        if cfg.max_grad_norm:
            out["grad_norm"] = clip_grads()
        opt.step()
        sched.step()
        # Gradients live only inside the step, as in the JAX step.
        opt.zero_grad(set_to_none=True)
        return out

    step.optimizer, step.scheduler = opt, sched
    step.loss_and_grads = loss_and_grads
    step.clip_grads = clip_grads
    return step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Build ``step(batch) -> {"accuracy", "loss"}``: the deterministic
    forward without gradients.  Sketches only shape gradients, but an
    explicit sketch generator (seeded 0, on the model's device) is passed
    anyway, so eval never takes the constant-key fallback (nor trips its
    strict mode)."""
    device = next(model.parameters()).device

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            logits = model(batch["input_ids"], batch.get("attention_mask"),
                           deterministic=True, sketch_generator=gen)
            labels = batch["labels"].long()
            preds = logits.argmax(-1)
            return {"accuracy": (preds == labels).float().mean(),
                    "loss": classification_loss(logits, labels)}

    return step


def save_checkpoint(path, model: torch.nn.Module, step: Callable) -> None:
    """Write ``model``, the optimizer and schedule of ``step`` (from
    :func:`make_train_step`) and the count of steps taken to ``path``."""
    torch.save({"model": model.state_dict(),
                "optimizer": step.optimizer.state_dict(),
                "scheduler": step.scheduler.state_dict(),
                "step": step.scheduler.last_epoch}, path)


def restore_checkpoint(path, model: torch.nn.Module, step: Callable) -> int:
    """Read a :func:`save_checkpoint` file into ``model`` and ``step``;
    returns the count of steps it had taken."""
    state = torch.load(path, map_location=next(model.parameters()).device)
    model.load_state_dict(state["model"])
    step.optimizer.load_state_dict(state["optimizer"])
    step.scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])
