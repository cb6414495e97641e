#!/usr/bin/env python3
"""Drive the PyTorch port's few-bit RoBERTa-base training step on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result is printed):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   the CUDA kernels from ``fewbit_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version at the main path's shapes,
   in f32 and bf16, with the tolerances below, and both timed with CUDA
   events.
3. Few-bit training steps of RoBERTa-base (12 layers, hidden 768, 12 heads,
   FFN 3072; random weights from a seed) on an MRPC-shaped batch, bs 64,
   seq 128, 3-bit GELU, countsketch at ratio 0.2, dropout on: 3 steps in
   f32 and one in bf16.  Every loss must be finite, and every step must
   launch kernels 1, 2 and 3 exactly 96, 12 and 12 times.  The few-bit
   forward must equal the exact forward of a vanilla model holding the
   same weights.
4. Vanilla against few-bit, with the same weights and batches, 4 timed
   steps each in turns: step time and peak memory above what was held
   before the step; the few-bit peak must be lower.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BS, SEQ = 64, 128
N = BS * SEQ          # rows of every projection on the main path
HIDDEN, FFN = 768, 3072
K_EFF = 2048          # aligned bucket count of ratio 0.2 at N = 8192
PER_STEP = {"matmul_input_sketch": 96, "dense_act_sketch": 12,
            "matmul_lut_backward": 12}

# Tolerance on max |kernel - plain|, as a fraction of max(1, max |plain|):
# f32 differs only by the order of the f32 sums; bf16 outputs may differ by
# one rounding step of bf16 (2^-8 relative) where the f32 sums differ.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# db and the column sum add 8192 rows: f32 order effects grow with N.
TOL_SUM = 1e-3
# Codes may differ only where the plain z lies within this distance of a
# border, and on at most this fraction of the elements.
FLIP_BAND, FLIP_FRACTION = 1e-3, 1e-4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} * {scale}")
    return err


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(smi)
    from fewbit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds():.1f} s)")
    return smi


def phase_kernels():
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.ops.bitpack import unpack_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec, borders, levels = resolve_activation("gelu", bits=3, device=dev)
    results = {name: [] for name in K.KERNELS}

    def rand(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    sigma = torch.randint(0, 2, (N,), generator=gen,
                          device=dev).float() * 2 - 1
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        tag = "f32" if dt == torch.float32 else "bf16"
        # Kernel 1, forward mode: an attention projection on x, the weight
        # an (out, in) parameter seen through .t().
        x = rand(N, HIDDEN, dt=dt)
        weight = rand(HIDDEN, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
        bias = rand(HIDDEN, scale=0.1, dt=dt)
        args = (x, weight.t(), bias, sigma, K_EFF)
        y, sk = K.fused_matmul_input_sketch(*args)
        y0, sk0 = K.matmul_input_sketch_plain(*args)
        errs = {"y": compare(f"k1 fwd {tag} y", y, y0, tol),
                "sketch": compare(f"k1 fwd {tag} sketch", sk, sk0, tol)}
        results["matmul_input_sketch"].append({
            "mode": "forward", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_matmul_input_sketch(*args)),
            "plain_ms": cuda_ms(lambda: K.matmul_input_sketch_plain(*args))})
        # Kernel 1, backward mode: dy @ w with the column sum for db.
        g = rand(N, HIDDEN, dt=dt)
        args = (g, weight, None, sigma, K_EFF, True)
        y, sk, cs = K.fused_matmul_input_sketch(*args)
        y0, sk0, cs0 = K.matmul_input_sketch_plain(*args)
        errs = {"dx": compare(f"k1 bwd {tag} dx", y, y0, tol),
                "sketch": compare(f"k1 bwd {tag} sketch", sk, sk0, tol),
                "colsum": compare(f"k1 bwd {tag} colsum", cs, cs0, TOL_SUM)}
        results["matmul_input_sketch"].append({
            "mode": "backward+colsum", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_matmul_input_sketch(*args)),
            "plain_ms": cuda_ms(lambda: K.matmul_input_sketch_plain(*args))})

        # Kernel 2: the FFN up projection with GELU, codes and sketch(y).
        up_w = rand(FFN, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
        up_b = rand(FFN, scale=0.1, dt=dt)
        args = (spec, x, up_w.t(), up_b, borders, sigma, K_EFF)
        y, packed, sk = K.fused_dense_act_sketch(*args)
        y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
        z0 = K.dot_f32(x, up_w.t()) + up_b.float()
        codes = unpack_codes(packed, spec.bits, N)
        codes0 = unpack_codes(packed0, spec.bits, N)
        flips = codes != codes0
        n_flips = int(flips.sum())
        if n_flips:
            near = (z0[flips][:, None] - borders[None, :]).abs().min(1)[0]
            if near.max().item() > FLIP_BAND:
                raise AssertionError(f"k2 {tag}: a code differs at "
                                     f"{near.max().item()} from a border")
        if n_flips > FLIP_FRACTION * codes.numel():
            raise AssertionError(f"k2 {tag}: {n_flips} codes differ")
        errs = {"y": compare(f"k2 {tag} y", y, y0, tol),
                "sketch": compare(f"k2 {tag} sketch", sk, sk0, tol),
                "code_flips": n_flips}
        results["dense_act_sketch"].append({
            "mode": "forward", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_dense_act_sketch(*args)),
            "plain_ms": cuda_ms(lambda: K.dense_act_sketch_plain(*args))})

        # Kernel 3: the FFN backward on kernel 2's codes, with the down
        # projection's (out, in) weight as wt.
        down_w = rand(HIDDEN, FFN, scale=FFN ** -0.5, dt=dt)
        args = (spec, packed, levels, g, down_w, sigma, K_EFF)
        dz, sk, db = K.fused_matmul_lut_backward(*args)
        dz0, sk0, db0 = K.matmul_lut_backward_plain(*args)
        errs = {"dz": compare(f"k3 {tag} dz", dz, dz0, tol),
                "sketch": compare(f"k3 {tag} sketch", sk, sk0, tol),
                "db": compare(f"k3 {tag} db", db, db0, TOL_SUM)}
        results["matmul_lut_backward"].append({
            "mode": "backward", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_matmul_lut_backward(*args)),
            "plain_ms": cuda_ms(lambda: K.matmul_lut_backward_plain(*args))})
    for name, cases in results.items():
        for c in cases:
            log(f"kernel {name} [{c['mode']}, {c['dtype']}]: errors "
                f"{c['errors']}, kernel {c['ms']:.3f} ms, plain "
                f"{c['plain_ms']:.3f} ms")
    return results


def _batches(dev, seed):
    from fewbit_tpu_torch.train import synthetic_glue

    for b in synthetic_glue(BS, SEQ, seed=seed):
        yield {"input_ids": torch.from_numpy(b["input_ids"]).long().to(dev),
               "attention_mask": torch.from_numpy(b["attention_mask"]).to(
                   dev),
               "labels": torch.from_numpy(b["labels"]).long().to(dev)}


def _model(dt, fewbit):
    from fewbit_tpu_torch.models import (RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.train import TrainConfig, make_train_step

    cfg = RobertaConfig(dtype=dt, gelu_bits=3 if fewbit else None,
                        proj_dim_ratio=0.2 if fewbit else None,
                        sketch="countsketch", fused_ffn=True)
    model = RobertaForSequenceClassification(
        cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
    step = make_train_step(model, TrainConfig(total_steps=100,
                                              learning_rate=1e-5))
    return model, step


def _timed_step(step, batch, gen):
    """One step: (loss, seconds, peak bytes above those held before)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step(batch, gen)["loss"].item()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return loss, dt, torch.cuda.max_memory_allocated() - held


def phase_forward_check(model):
    """The few-bit forward is exact: its logits equal those of a vanilla
    model holding the same weights (f32 sums in another order: tolerance
    1e-3).  Returns that vanilla model and its step."""
    vanilla, vstep = _model(torch.float32, fewbit=False)
    rename = {"ffn.up_weight": "intermediate.weight",
              "ffn.up_bias": "intermediate.bias",
              "ffn.down_weight": "ffn_output.weight",
              "ffn.down_bias": "ffn_output.bias"}
    state = {}
    for k, v in model.state_dict().items():
        for old, new in rename.items():
            k = k.replace(old, new)
        state[k] = v
    vanilla.load_state_dict(state)
    batch = next(_batches("cuda", SEED + 7))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        got = model(batch["input_ids"], batch["attention_mask"],
                    sketch_generator=gen)
        want = vanilla(batch["input_ids"], batch["attention_mask"])
    err = compare("few-bit forward vs vanilla logits", got, want, 1e-3)
    log(f"few-bit forward logits {tuple(got.shape)} vs vanilla: max abs "
        f"err {err}")
    return vanilla, vstep


def _checked_step(tag, step, batch, gen):
    from fewbit_tpu_torch.ops import kernels as K

    before = K.launch_counts()
    loss, sec, peak = _timed_step(step, batch, gen)
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    if delta != PER_STEP:
        raise AssertionError(f"{tag}: launches {delta}, expected {PER_STEP}")
    if not np.isfinite(loss):
        raise AssertionError(f"{tag}: loss {loss}")
    log(f"{tag}: loss {loss:.6f}, {sec * 1e3:.1f} ms, peak "
        f"{peak / 2**30:.3f} GiB above held, launches {delta}")
    return loss


def phase_train(results):
    from fewbit_tpu_torch.ops import kernels as K

    batches = _batches("cuda", SEED)
    gen = torch.Generator().manual_seed(SEED)
    model, step = _model(torch.float32, fewbit=True)
    vmodel, vstep = phase_forward_check(model)

    # The main path: every count starts at 0 here.
    K.reset_launch_counts()
    losses = [_checked_step(f"few-bit f32 step {i}", step, next(batches),
                            gen) for i in range(3)]
    main_counts = K.launch_counts()
    for name, cases in results.items():
        for c in cases:
            c["launches"] = main_counts[name]

    # Vanilla against few-bit, same weights and batches, in turns
    # (vanilla, few-bit, few-bit, vanilla, ...).  Each model has taken a
    # step, so its optimizer state is in what is held before the step.
    vstep(next(_batches("cuda", SEED)), gen)
    timed = {"vanilla": [], "fewbit": []}
    peaks = {"vanilla": [], "fewbit": []}
    steps = {"vanilla": vstep, "fewbit": step}
    for order in (("vanilla", "fewbit"), ("fewbit", "vanilla")) * 2:
        batch = next(batches)
        for name in order:
            loss, sec, peak = _timed_step(steps[name], batch, gen)
            if not np.isfinite(loss):
                raise AssertionError(f"{name}: loss {loss}")
            timed[name].append(sec * 1e3)
            peaks[name].append(peak)
    v_ms, fb_ms = (statistics.median(timed[k]) for k in ("vanilla",
                                                         "fewbit"))
    v_peak, fb_peak = max(peaks["vanilla"]), max(peaks["fewbit"])
    log(f"f32 bs {BS} seq {SEQ}: step ms vanilla {timed['vanilla']} "
        f"(median {v_ms:.2f}), few-bit {timed['fewbit']} (median "
        f"{fb_ms:.2f}); peak above held: vanilla {v_peak} B "
        f"({v_peak / 2**30:.3f} GiB), few-bit {fb_peak} B "
        f"({fb_peak / 2**30:.3f} GiB), saving "
        f"{100 * (1 - fb_peak / v_peak):.2f}%")
    if not fb_peak < v_peak:
        raise AssertionError(f"few-bit peak {fb_peak} >= vanilla {v_peak}")
    del model, step, vmodel, vstep, steps
    torch.cuda.empty_cache()

    bmodel, bstep = _model(torch.bfloat16, fewbit=True)
    bf16_loss = _checked_step("few-bit bf16 step", bstep,
                              next(_batches("cuda", SEED)), gen)
    return {"f32_losses": losses, "bf16_loss": bf16_loss,
            "vanilla_step_ms": timed["vanilla"],
            "fewbit_step_ms": timed["fewbit"],
            "vanilla_peak_bytes": v_peak, "fewbit_peak_bytes": fb_peak}


def main():
    smi = phase_device()
    results = phase_kernels()
    train = phase_train(results)
    from fewbit_tpu_torch.ops import kernels as K

    kernels = []
    for name, cases in results.items():
        _, _, replaces, source = K.KERNELS[name]
        first = cases[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": first["launches"],
            "max_abs_err": max(v for c in cases if c["dtype"] == "f32"
                               for k, v in c["errors"].items()
                               if k != "code_flips"),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "cases": [{k: c[k] for k in ("mode", "dtype", "errors", "ms",
                                         "plain_ms")} for c in cases]})
    log(json.dumps({"train": train, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
