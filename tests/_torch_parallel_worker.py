"""One rank of the 4-process gloo job of ``tests/test_torch_parallel.py``.

    python tests/_torch_parallel_worker.py RANK WORLD STORE WORKDIR

Joins the job through the file store ``STORE`` (``init_distributed`` with
gloo on the CPU), reads the cases the test wrote to ``WORKDIR/inputs.pt``
(JAX parameter trees as numpy arrays, batches, configs), runs each on its
mesh and writes what it saw to ``WORKDIR/rank<RANK>.pt``:

* ``tp_cfg``, ``tp_r``, ``tp_gpt``, ``tp_dropout``, ``tp_flash_r``,
  ``tp_flash_gpt`` -- dp=1 x tp=2 on ranks 0 and 1: a tp model loaded
  with its slice of a JAX tree, one forward and backward (logits, loss,
  local gradients); ``tp_dropout`` with attention dropout on, the
  ``tp_flash`` cases with ``flash_attention=True``;
* ``tp_clip`` -- the same mesh, R with ``max_grad_norm``: the clipped
  gradients of one ``loss_and_grads`` + ``clip_grads`` (with the norm, and
  the norm of the rank's own gradients alone), then three steps (the
  norms the clip saw, the parameters' updates);
* ``dp_r``, ``dp_gpt`` -- dp=2 on ranks 0 and 1: rank 1's weights moved
  and ``replicate``d from rank 0, the model in
  ``DistributedDataParallel``, ``make_train_step(dp_group=...)``'s
  ``loss_and_grads`` on the rank's half of the batch;
* ``dp_tp`` -- dp=2 x tp=2 on all four: ``init_dp_tp_state`` (its
  parameters) and one ``dp_tp_train_step`` step (loss, parameters after
  it);
* ``signs`` -- the same mesh, a countsketched model: the sketch signs each
  rank drew in ``loss_and_grads``.

Imports torch and the port only, never JAX.
"""

import sys

import numpy as np
import torch


def _batch(b):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in b.items()}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _classes(family):
    from fewbit_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.train import causal_lm_loss, classification_loss

    if family == "gpt":
        return GPTConfig, GPTForCausalLM, causal_lm_loss
    return (RobertaConfig, RobertaForSequenceClassification,
            classification_loss)


def _tp_case(case, mesh):
    from fewbit_tpu_torch.models import load_flax_params

    cfg_cls, model_cls, loss_fn = _classes(case["family"])
    cfg = cfg_cls(**case["cfg"], tp_size=2, tp_axis="tp")
    model = model_cls(cfg, device="cpu", tp_group=mesh.tp_group)
    load_flax_params(model, case["params"], tp_rank=mesh.tp_rank)
    b = _batch(case["batch"])
    seed = case.get("dropout_seed")
    logits = model(b["input_ids"], b["attention_mask"],
                   deterministic=seed is None,
                   dropout_generator=(None if seed is None else
                                      torch.Generator().manual_seed(seed)),
                   sketch_generator=torch.Generator().manual_seed(
                       case["sketch_seed"]))
    loss = loss_fn(logits, b["labels"])
    loss.backward()
    return {"logits": logits.detach(), "loss": loss.detach(),
            "grads": _grads(model)}


def _clip_case(case, mesh):
    from fewbit_tpu_torch.models import load_flax_params
    from fewbit_tpu_torch.train import TrainConfig, make_train_step

    cfg_cls, model_cls, loss_fn = _classes(case["family"])
    cfg = cfg_cls(**case["cfg"], tp_size=2, tp_axis="tp")
    model = model_cls(cfg, device="cpu", tp_group=mesh.tp_group)
    load_flax_params(model, case["params"], tp_rank=mesh.tp_rank)
    step = make_train_step(model, TrainConfig(**case["train"]),
                           loss_fn=loss_fn)
    b = _batch(case["batch"])
    step.loss_and_grads(b, torch.Generator().manual_seed(case["probe_seed"]))
    local = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()))
    norm = step.clip_grads()
    clipped = _grads(model)
    model.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    outs = [step(b, gen) for _ in range(case["steps"])]
    return {"norm": norm, "local_norm": local, "clipped": clipped,
            "norms": [o["grad_norm"] for o in outs],
            "losses": [o["loss"] for o in outs],
            "updates": {n: p.detach() - before[n]
                        for n, p in model.named_parameters()}}


def _dp_case(case, mesh):
    from fewbit_tpu_torch.models import load_flax_params
    from fewbit_tpu_torch.parallel import (data_parallel_step, replicate,
                                           shard_batch)
    from fewbit_tpu_torch.train import TrainConfig, make_train_step

    cfg_cls, model_cls, loss_fn = _classes(case["family"])
    model = model_cls(cfg_cls(**case["cfg"]), device="cpu")
    load_flax_params(model, case["params"])
    if mesh.dp_rank:  # replicate undoes it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    replicated = {n: p.detach().clone()
                  for n, p in replicate(model, mesh).named_parameters()}
    step = make_train_step(data_parallel_step(model, mesh),
                           TrainConfig(total_steps=10), loss_fn=loss_fn,
                           dp_group=mesh.dp_group)
    loss = step.loss_and_grads(shard_batch(_batch(case["batch"]), mesh),
                               torch.Generator().manual_seed(0))
    return {"loss": loss, "grads": _grads(model), "replicated": replicated}


def _dp_tp_case(case, mesh):
    from fewbit_tpu_torch.models import (RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.parallel import (dp_tp_train_step,
                                           init_dp_tp_state, shard_batch)
    from fewbit_tpu_torch.train import TrainConfig

    cfg = RobertaConfig(**case["cfg"], tp_size=2, tp_axis="tp")
    model = init_dp_tp_state(RobertaForSequenceClassification, cfg, mesh,
                             seed=0, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = dp_tp_train_step(model, TrainConfig(total_steps=4,
                                               learning_rate=1e-4), mesh)
    loss = step(shard_batch(_batch(case["batch"]), mesh),
                torch.Generator().manual_seed(0))["loss"]
    return {"loss": loss, "init": init,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _signs_case(case, mesh):
    """The countsketch signs each projection drew in one step on the
    mesh, in draw order."""
    import importlib

    from fewbit_tpu_torch.models import (RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.parallel import (dp_tp_train_step,
                                           init_dp_tp_state, shard_batch)
    from fewbit_tpu_torch.train import TrainConfig

    cfg = RobertaConfig(**case["cfg"], tp_size=2, tp_axis="tp")
    model = init_dp_tp_state(RobertaForSequenceClassification, cfg, mesh,
                             seed=0, device="cpu")
    step = dp_tp_train_step(model, TrainConfig(total_steps=4), mesh)
    linear = importlib.import_module("fewbit_tpu_torch.functional.linear")
    drawn, draw = [], linear.draw_signs

    def recording(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    linear.draw_signs = recording
    try:
        step.loss_and_grads(shard_batch(_batch(case["batch"]), mesh),
                            torch.Generator().manual_seed(0))
    finally:
        linear.draw_signs = draw
    return {"signs": drawn}


def main(rank: int, world: int, store: str, workdir: str) -> None:
    from fewbit_tpu_torch.parallel import (init_distributed,
                                           make_dp_tp_mesh, make_mesh)

    torch.set_num_threads(1)
    init_distributed(num_processes=world, process_id=rank, device="cpu",
                     init_method=f"file://{store}")
    # Trees and batches this test wrote itself.
    cases = torch.load(f"{workdir}/inputs.pt", weights_only=False)
    # Every rank makes every group, in the same order.
    tp_mesh, dp_mesh = make_dp_tp_mesh(1, 2), make_mesh(2)
    grid = make_dp_tp_mesh(2, 2)
    out = {"dp_rank": grid.dp_rank, "tp_rank": grid.tp_rank}
    if tp_mesh.member:
        for name in ("tp_cfg", "tp_r", "tp_gpt", "tp_dropout", "tp_flash_r",
                     "tp_flash_gpt"):
            out[name] = _tp_case(cases[name], tp_mesh)
        out["tp_clip"] = _clip_case(cases["tp_clip"], tp_mesh)
    if dp_mesh.member:
        for name in ("dp_r", "dp_gpt"):
            out[name] = _dp_case(cases[name], dp_mesh)
    out["dp_tp"] = _dp_tp_case(cases["dp_tp"], grid)
    out["signs"] = _signs_case(cases["signs"], grid)
    torch.save(out, f"{workdir}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
