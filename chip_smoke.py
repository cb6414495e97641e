#!/usr/bin/env python3
"""Drive the PyTorch port's few-bit training steps, its model surgery, its
data and tensor parallelism, its examples, its long-sequence rows and its
megakernel experiment, on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result is printed):

1. Device: the card's name and power limit (nvidia-smi), and the build of
   the CUDA kernels from ``fewbit_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version at its path's shapes, in
   f32 and bf16, with the tolerances below, and both timed with CUDA
   events (per call, the host's share included), beside its bound: the
   least time the card could take, from the bytes the function must move
   and the operations it does on these inputs (``bound``).  Kernels 1, 2
   and 3 also by the profiler (device time), with the route and tile their
   host chose, the achieved TFLOP/s and the share of the bound reached.
   Kernels 4 and 5 also by device time, with their share of the bound.
   F1, and F2 with F3, beside the one PyTorch call that computes the same
   function (``scaled_dot_product_attention`` and its backward, per call
   and on the device): a yardstick that the port never calls.  The GEMM
   kernels have no such call; the bare ``torch.matmul`` of their product
   is printed as context.  F1, F2 and F3 (the tensor-core kernels) are also
   held against an f64 evaluation of the plain formulas on a batch slice,
   where their error must be nonzero and within the tolerance (the plain
   versions' and the replaced CUDA-core kernels' errors against f64 are
   printed beside); they write into outputs filled with NaN, two launches
   must give equal bits, and at the GPT shape they must not be slower than
   the CUDA-core kernels they replaced.
3. RoBERTa-base (12 layers, hidden 768, 12 heads, FFN 3072; random weights
   from a seed), the fused few-bit FFN: an MRPC-shaped batch, bs 64, seq
   128, 3-bit GELU, countsketch at ratio 0.2, dropout on: 3 f32 steps and
   one bf16 step, each launching kernels 1, 2 and 3 exactly 96, 12 and 12
   times; the few-bit forward equals the exact forward of a vanilla model
   holding the same weights; vanilla against few-bit, 4 timed steps each
   in turns (step time, peak memory above what was held before the step;
   the few-bit peak must be lower); then two few-bit steps under the
   profiler: device time per step by kernel.
4. GPT-2 small (12 layers, hidden 768, 12 heads, FFN 3072, vocab 50257,
   1024 positions, tied head), few-bit: a ``synthetic_lm`` batch, bs 8,
   seq 1024, 3-bit GELU, countsketch at ratio 0.2, dropout on: 3 f32 steps
   and one bf16 step, each launching kernels 1, 6 and 5 exactly 96, 12 and
   12 times; the same forward check; vanilla against few-bit, 4 steps each
   in turns, the few-bit peak lower.
5. RoBERTa-base with the unfused few-bit FFN (``fused_ffn=False``): 2 f32
   steps, each launching kernels 1, 4 and 5 exactly 96, 12 and 12 times.
6. GPT-2 small few-bit with flash attention (``flash_attention=True``,
   attention dropout 0): the forward check against the vanilla
   standard-attention model, 3 f32 steps each launching kernels 1, 6, 5
   and the flash kernels F1, F2, F3 exactly 96, 12, 12, 12, 12 and 12
   times; vanilla (standard attention, attention dropout 0) against
   few-bit + flash, 4 steps each in turns, the few-bit peak lower; the
   few-bit step on the standard path with attention dropout 0 for
   comparison; one bf16 step.
7. RoBERTa-base fused few-bit FFN with flash attention and the padded
   batch: 2 f32 steps, each launching kernels 1, 2, 3 and F1-F3 exactly
   96, 12, 12 and 12 each.
8. RoBERTa-base at the reference's default few-bit config,
   ``RobertaConfig(gelu_bits=3, proj_dim_ratio=0.2)``: the gaussian sketch
   in every projection and ``FusedDenseActivation`` for the FFN, bs 64 x
   seq 128: the forward check, 3 f32 steps each launching kernels 6 and 5
   exactly 12 times and no other kernel, vanilla against few-bit (the
   few-bit peak lower), two profiled steps, one bf16 step; the eval step
   on a held batch under ``FEWBIT_TPU_STRICT_SKETCH=1``; a checkpoint
   saved after step 2 and restored into a fresh model and step, whose step
   3 must give the uninterrupted run's loss to the bit.
9. The MLP tower of ``benchmark/bench_linear.py:30-31``, ``MLP(features=
   (3072, 3072, 3072, 768), gelu_bits=3, proj_dim_ratio=0.2)`` on x of
   (8192, 768), SGD on the mean square output: the forward check against
   the exact MLP, 3 f32 steps each launching kernels 4 and 5 exactly 3
   times, exact against few-bit in turns (the few-bit peak lower), one
   bf16 step.
10. Surgery (``phase_surgery``; ``python3 chip_smoke.py --surgery`` runs it
   alone): path 5's vanilla model converted by ``map_module`` +
   ``convert_linear`` (countsketch at ratio 0.2 in every projection path 5
   sketches), its GELU through ``use_fewbit_activation("gelu", 3)``,
   against path 5's config-built model holding the same weights, from one
   seed: logits, loss and every gradient equal to the bit (in
   deterministic mode), both launching kernels 1, 4 and 5 exactly 96, 12
   and 12 times a step; one step each and 4 x 2 timed in turns in the
   caller's mode (step ms, peak above held), the losses within
   SURGERY_LOSS_RTOL; ``estimate_memory_usage`` of one FFN (exact and
   3-bit GELU) and one projection (``nn.Linear`` and the countsketch
   patch) equal to the bytes their shapes imply; the 48 attention
   projections in ``VarianceEstimator`` for one untimed step, each capture
   equal to what hooks on the projection see, each triple within
   VARIANCE_RTOL of f64 on the CPU.  Its launches are its own summary.
11. Parallelism (``phase_parallel``; ``python3 chip_smoke.py --parallel``
   runs it alone): NCCL at world size 1, dp=1 x tp=1, path R: one
   ``data_parallel_step`` step equal to the plain step on the rank's
   folded generator to the bit (deterministic mode).  Then two rank
   processes (``chip_smoke.py --rank R DIR``, each with RANK_TIMEOUT) on
   the one card, gloo with CUDA tensors, since NCCL cannot put two ranks
   on one device: paths R and G at tp=2 without dropout, each rank's slice
   cut from the single-device model (its biases drawn at random) by
   ``shard_tp_params``; each rank launches the path's kernels 96, 12, 12
   times a step; its logits, loss and launches equal the single device's
   (TOL), every layer's codes differ from the single device's only within
   FLIP_BAND of a border, the gathered gradients within TP_GRAD_RTOL, three
   f32 steps without warmup (their losses within PARALLEL_LOSS_RTOL, the
   gathered updates within TP_UPDATE_RTOL), one bf16 step finite; each
   fault of TP_FAULTS, planted in a run of its own, must fail one of these
   checks; per-rank step ms and peak above held are printed (gloo stages
   every all-reduce through the host: not NCCL's speed).  dp=2: R's gradient
   after ``DistributedDataParallel`` equals the mean of the two half-batch
   gradients on the ranks' folded generators; GPT-2 small's loss with
   unequal valid tokens per rank equals the full batch's.  Rank 0's
   residual bytes of its layer-0 FFN, query and output equal what their
   local shapes imply.  The same checks, without the planted faults, on
   the flash paths at tp=2 (F1-F3 on each rank's 6 local heads); and R at
   tp=2 under ``max_grad_norm = TP_CLIP_NORM`` (every step clips): each
   rank's norm the single device's, the gathered clipped gradients within
   TP_GRAD_RTOL, three steps' losses and gathered updates as above, and
   TP_CLIP_FAULT planted in a run of its own, which those checks must
   see.  The tp paths' launches go into the kernels line.
12. The sketch kinds: ``linear_grp`` at (8192, 768) -> 768 for each kind
   and ``linear_crs``, f32 and bf16: forward and dx against the exact
   ``linear`` (asserted), dW's relative error against the exact dW over
   four draws, the bytes the backward keeps, forward + backward ms.
13. The megakernel experiment (``fewbit_tpu_torch.tools.exp_megakernel``) at
   its own shape, N = 8192, K = 768, M = 3072, 3-bit GELU: the four
   tensor-core schedules of kernel 6 (k loop with its epilogue ablation,
   direct, emit, pipelined), the shipped ``fused_dense_act``, the first
   CUDA-core kernel and the bare matmul, in f32, bf16 -> f32 and bf16, 5
   calls timed 3 times each; every schedule's launch count is fixed
   (``EXP_LAUNCHES``).

The kernel phase holds each of the four schedules against the one plain
version at that shape in every type pair its envelope admits, the k loop's
ablation too, and the two whose f32 weight panel does not fit at K = 768
also in f32 at K = 128; and it checks that the shipped kernel 6 is not
slower than the CUDA-core kernel it replaced.  It also holds the kernels
of the tp=2 paths at one rank's widths (kernel 1 at 768 -> 384 and 384 ->
768, both modes; kernels 2 and 3 at 768 <-> 1536; kernel 6 at 768 ->
1536; kernel 5 at (8192, 1536); F1-F3 on the 6 local heads a rank,
(b, s, 6, 64) views of its (b, s, 384) projection at GPT-2 small's and
RoBERTa's batches) into outputs filled with NaN, with their device time
and share of the bound; kernel 1's other cases write into NaN-filled
outputs too.  Every device time names how it was read
(``device_ms_source``): the profiler, or CUDA events where every profiled
run read below the call's bound, which is logged.

The activation phase (after the kernel phase; ``python3 chip_smoke.py
--activations`` runs it alone) holds every activation id of ``ACT_IDS``
(the default arguments, the ids that take arguments once more with
others; ``stepwise`` by parity, with and without a shift, a 5-level LUT
and a 6-bit one) through kernels 4 and 5 at the MLP tower's (8192, 3072),
every id but ``stepwise`` through kernel 6's scheduled route and kernel 5
at 8192 x 768 -> 3072, and ``relu`` and ``silu`` (and ``gelu``, timed)
through kernels 2 and 3 at the FFN shape (``relu`` and ``silu`` also
through kernel 2' and its CUDA-core kernel), in f32 and bf16, each against
its plain version: kernel 4's codes and every dx equal, codes of kernels
6, 2 and 2' flipped only within FLIP_BAND of a border or a predicate's
threshold, y within TOL (kernel 6's outside FLIP_BAND of a jump of the
forward); device ms per id.  Then its path: ``FewBitFFN(768, 3072, 768,
activation=...)`` at N = 8192 with ``relu`` and ``silu``, forward equal to
the exact block within TOL_SUM, backward finite, launching kernels 2 and 3
once each per call and nothing else.

The kernel phase also holds kernel 2' (kernel 2 with the input sketch,
which no path runs) against its plain version on the route its host chose
(printed with the tile width), into outputs filled with NaN, two launches
to equal bits, with its device time and share of the bound as kernels 1-3
have them, beside the CUDA-core kernel it replaced and the separate sketch
pass alone, and times the three ways to get (y, codes, sk_y, sk_x): kernel
2 then the plain sketch of x (the FFN's forward), kernel 2 then the
separate pass, and kernel 2'; each on a line of its own.  It times flash
attention (F1, then F2 and F3 through the autograd op) against the
standard attention's forward and backward at seq 128, 256, 512 and 1024
(8192 tokens) in f32 and bf16: the card's own crossover for
``flash_attention="auto"``, printed, not acted on.

Every loss must be finite.  Each path's launch counts start at 0 just
before it.  The experiment's rows are a JSON line of their own; the line
before the last is a JSON object with each kernel's launches, error, times
and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The examples phase (after the parallel phase; ``python3 chip_smoke.py
--examples`` runs it alone) prints the corpus directory's files and bytes,
holds kernels 1-6 against their plain versions at the examples' shapes
(``EX_SHAPES``: K = 128 <-> 512 at 2048 and 4096 rows, f32 and for the LM
bf16, and RoBERTa-base's 768 <-> 3072 at 2048 rows) into outputs filled
with NaN, with their device times beside their bounds; then drives the
twins of ``examples/*.py`` (``fewbit_tpu_torch/examples``): every row of
convergence_parity, lm_parity_real_text (f32 and bf16) and
classification_parity_real_text (doc with a 2-step pretrain, pair) for one
probed step and one evaluation forward, each launching exactly its
``EX_LAUNCHES``, then each ``main`` at EX_STEPS steps, its launches those of
its steps and evaluations; finetune_glue at RoBERTa-base width (bs 16 x seq
128, f32, 3 bits, ratio 0.2, gaussian: kernels 6 and 5; countsketch: 1, 2
and 3) with ``--glue`` on a fixture it writes, ``--log-dir`` then
``summarize_runs``, and ``--checkpoint-dir``, whose restored next step
equals the uninterrupted one to the bit (deterministic mode), and vanilla
against few-bit in turns (step ms, peak above held; the few-bit peak
lower); memory_profile
``--time`` at 2^24 elements, its bytes those its shapes imply.  The
examples' launches go into the kernels line.  Without the corpus the
real-text examples are left out.

The long-sequence phase (after the examples phase; ``python3
chip_smoke.py --longseq`` runs it alone) holds kernels 1, 6 and 5 at 4096
rows (768 <-> 3072, f32; RoBERTa's 8192 rows are the kernel phase's), and
F1-F3 at (2, 12, 2048, 64) and (1, 12, 4096, 64) causal and (4, 12, 2048,
64) with a padding mask, against their plain versions (F1-F3 also against
f64, beside ``scaled_dot_product_attention``); then drives the twin of
``tools/bench_longseq.py`` (``fewbit_tpu_torch.tools.bench_longseq``) on
GPT-2 small at 2 x 2048 and 1 x 4096 and RoBERTa-base at 4 x 2048, f32:
vanilla, few-bit, vanilla + flash and few-bit + flash, each with its
launches per step (none; the path's kernels; F1-F3 12 each with flash),
peak above held and step ms; every configuration must fit (an OOM row
fails the phase), and the few-bit peak must be below vanilla's, with and
without flash.  Its launches go into the kernels line.

``python3 chip_smoke.py --profile PATH`` runs only the device phase and the
few-bit steps of one path (a name in ``PATHS``), four timed without the
profiler and two under it: the way to read an older tree's step and device
time per step with this script.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BS, SEQ = 64, 128     # RoBERTa's MRPC-shaped batch
GPT_BS, GPT_SEQ = 8, 1024
N = BS * SEQ          # rows of every projection, both models
assert N == GPT_BS * GPT_SEQ
HIDDEN, FFN = 768, 3072
K_EFF = 2048          # aligned bucket count of ratio 0.2 at N = 8192
# Kernel launches per training step on each path; every other kernel 0.
FLASH = {"flash_forward": 12, "flash_backward_dkv": 12,
         "flash_backward_dq": 12}
PATHS = {
    "roberta_fused_ffn": {"matmul_input_sketch": 96, "dense_act_sketch": 12,
                          "matmul_lut_backward": 12},
    "gpt2_small": {"matmul_input_sketch": 96, "dense_act": 12,
                   "fused_backward": 12},
    "roberta_unfused_ffn": {"matmul_input_sketch": 96, "fused_forward": 12,
                            "fused_backward": 12},
    "gpt2_small_flash": {"matmul_input_sketch": 96, "dense_act": 12,
                         "fused_backward": 12, **FLASH},
    "roberta_flash": {"matmul_input_sketch": 96, "dense_act_sketch": 12,
                      "matmul_lut_backward": 12, **FLASH},
    # The reference's default config: a gaussian sketch never takes kernel 1.
    "roberta_default": {"dense_act": 12, "fused_backward": 12},
    "mlp": {"fused_forward": 3, "fused_backward": 3},
}
MLP_FEATURES = (FFN, FFN, FFN, HIDDEN)   # benchmark/bench_linear.py:30-31
# The megakernel experiment: calls per row (one to size the outputs, two to
# warm up, 3 timed blocks of EXP_ITERS), and the rows per kernel at its
# shape: the shipped kernel 6 in f32 and bf16; the k loop with and without
# its epilogue in the three type pairs; the direct schedule at both panel
# widths and the emit schedule at the one its envelope admits, in bf16 ->
# f32 and bf16 (in f32 their panel does not fit: printed, not launched); the
# pipelined schedule in the three pairs.
EXP_ITERS, EXP_ROUNDS = 5, 3
EXP_CALLS = 1 + 2 + EXP_ITERS * EXP_ROUNDS
EXP_LAUNCHES = {"dense_act": 2 * EXP_CALLS, "dense_act_kloop": 6 * EXP_CALLS,
                "dense_act_direct": 4 * EXP_CALLS,
                "dense_act_emit": 2 * EXP_CALLS,
                "dense_act_pipelined": 3 * EXP_CALLS}
# Kernel 2' has no path: the JAX package's fewbit_ffn never passes sigma_x
# (fewbit_tpu/functional/ffn.py:142-148), nor does the port's.  It is held
# against its plain version in the kernel phase only.
NO_PATH = {"dense_act_sketch_x"}
HEADS, HEAD_DIM = 12, 64

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


def tensor_bytes(*objs):
    """Bytes of every tensor in ``objs`` (nested tuples allowed), each
    counted once: what a function must read or write."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(ops, rate, nbytes):
    """The least milliseconds the card could take: the larger of ``ops``
    at the card's peak rate for ``rate`` and ``nbytes`` at its memory rate
    (the published peaks, ``fewbit_tpu_torch.tools.timing``).  Returns the
    keys of a case."""
    from fewbit_tpu_torch.tools.timing import bound_ms

    ms, by = bound_ms(ops, rate, nbytes)
    return {"ops": ops, "bytes": nbytes, "bound_ms": ms, "bound_by": by}


def gemm_rate(dt):
    return "f32" if dt == torch.float32 else "bf16"


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


def code_flips(tag, packed, packed0, z0, borders, bits):
    """Codes that differ between a kernel and its plain version: only where
    the plain z lies within FLIP_BAND of a border, on at most FLIP_FRACTION
    of the elements.  Returns their count."""
    from fewbit_tpu_torch.ops.bitpack import unpack_codes

    rows = z0.shape[0]
    flips = unpack_codes(packed, bits, rows) != unpack_codes(packed0, bits,
                                                             rows)
    n_flips = int(flips.sum())
    if n_flips:
        near = (z0[flips][:, None] - borders[None, :]).abs().min(1)[0]
        if near.max().item() > FLIP_BAND:
            raise AssertionError(f"{tag}: a code differs at "
                                 f"{near.max().item()} from a border")
    if n_flips > FLIP_FRACTION * flips.numel():
        raise AssertionError(f"{tag}: {n_flips} codes differ")
    return n_flips


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


def device_time(fn, bound_ms=None, reps=10, key="device_ms"):
    """``{key: ms, key + "_source": source}``: device milliseconds of
    ``fn`` per call and how they were read
    (``fewbit_tpu_torch.tools.act_timing.device_time``): ``"profiler"``,
    or ``"events"`` where every profiled run read below ``bound_ms`` (the
    call's bound) and the call was timed again by CUDA events, which is
    logged."""
    from fewbit_tpu_torch.tools.act_timing import device_time as timed

    ms, source = timed(fn, reps, bound_ms=bound_ms)
    if source != "profiler":
        log(f"{key}: every profiled run read below the bound {bound_ms} ms;"
            f" {ms} ms per call by CUDA events")
    return {key: ms, f"{key}_source": source}


def device_ms(fn, bound_ms=None, reps=10):
    """The milliseconds of :func:`device_time` alone."""
    return device_time(fn, bound_ms, reps)["device_ms"]


def _gemm_case(results, name, mode, tag, wrapper, plain, args, errs, route,
               tile, flop, a, w):
    """A tensor-core GEMM kernel (1, 2 or 3) on one input, already held
    against its plain version (``errs``): the route and tile its host
    chose, call times by CUDA events, device times by the profiler, its
    bound on these inputs, the achieved TFLOP/s of ``flop`` and the share
    of the bound on device time, and, as context only, the device time of
    the bare ``torch.matmul`` of the same product ``a @ w`` (not the same
    function: no epilogue, no codes, no sketch)."""
    least = bound(flop, gemm_rate(a.dtype), tensor_bytes(args, wrapper(*args)))
    case = {"mode": mode, "dtype": tag, "errors": errs, "route": route,
            "tile": tile,
            "ms": cuda_ms(lambda: wrapper(*args)),
            "plain_ms": cuda_ms(lambda: plain(*args)),
            **device_time(lambda: wrapper(*args), least["bound_ms"]),
            **device_time(lambda: plain(*args), least["bound_ms"],
                          key="plain_device_ms"),
            **least,
            "library_ms": None,
            "matmul_only_device_ms": device_ms(lambda: torch.matmul(a, w))}
    case["tflops"] = flop / case["device_ms"] / 1e9
    case["plain_tflops"] = flop / case["plain_device_ms"] / 1e9
    case["bound_share"] = case["bound_ms"] / case["device_ms"]
    results[name].append(case)


def _k1_case(results, mode, tag, names, args, tol):
    """Kernel 1 on one input against its plain version, into outputs
    filled with NaN."""
    from fewbit_tpu_torch.ops import kernels as K

    x, w = args[:2]
    (n, kdim), m = x.shape, w.shape[1]
    want = K.matmul_input_sketch_plain(*args)
    got = K.fused_matmul_input_sketch(*args, out=_nan_like(*want))
    errs = {name: compare(f"k1 {mode} {tag} {name}", a, b,
                          TOL_SUM if name == "colsum" else tol)
            for name, a, b in zip(names, got, want)}
    fused, bn = K.matmul_sketch_route(kdim, m, x.dtype)
    _gemm_case(results, "matmul_input_sketch", mode, tag,
               K.fused_matmul_input_sketch, K.matmul_input_sketch_plain,
               args, errs,
               "fused sketch" if fused else "separate sketch pass",
               f"{K.K1_BM}x{bn}", 2 * n * kdim * m, x, w)


def _ffn_case(results, name, mode, tag, wrapper, plain, args, errs, a, w):
    """Kernel 2 or 3 on one input, already held against its plain
    version."""
    from fewbit_tpu_torch.ops import kernels as K

    (n, kdim), m = a.shape, w.shape[1]
    _gemm_case(results, name, mode, tag, wrapper, plain, args, errs,
               "TMA ring + wgmma",
               f"{K.FG_BM}x{K.ffn_gemm_route(m, a.dtype)}", 2 * n * kdim * m,
               a, w)


def _sketch_x_case(results, spec, borders, args, sigma_x, z0, tag, tol):
    """Kernel 2' at the FFN up projection (``args``: kernel 2's) against its
    plain version, into NaN-filled outputs, twice for equal bits; timed as
    kernels 1-3 are (``_gemm_case``), beside the CUDA-core kernel it
    replaced and the separate sketch pass alone; and the three ways to get
    (y, codes, sk_y, sk_x), twice in turns: (a) kernel 2, then the plain
    ``countsketch_signed`` of x (what the FFN's forward does), (b) kernel
    2, then the separate pass ``input_sketch``, (c) kernel 2'."""
    from fewbit_tpu_torch.ops import kernels as K

    x, w = args[1], args[2]
    dt = x.dtype
    xargs = (*args, sigma_x)
    want = K.dense_act_sketch_x_plain(*xargs)
    got = K.fused_dense_act_sketch_x(*xargs, out=_nan_like(*want))
    again = K.fused_dense_act_sketch_x(*xargs, out=_nan_like(*want))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"k2' {tag}: two launches differ")
    del again
    names = ("y", "sketch_y", "sketch_x")
    errs = {name: compare(f"k2' {tag} {name}", a, b, tol)
            for name, a, b in zip(names, got[:1] + got[2:],
                                  want[:1] + want[2:])}
    errs["code_flips"] = code_flips(f"k2' {tag}", got[1], want[1], z0,
                                    borders, spec.bits)
    simt = K.dense_act_sketch_x_simt(*xargs)
    simt_errs = {name: compare(f"k2' simt {tag} {name}", a, b, tol)
                 for name, a, b in zip(names, simt[:1] + simt[2:],
                                       want[:1] + want[2:])}
    simt_errs["code_flips"] = code_flips(f"k2' simt {tag}", simt[1],
                                         want[1], z0, borders, spec.bits)
    sep = K.input_sketch(x, sigma_x, K_EFF, out=_nan_like(want[3]))
    sep_err = compare(f"input_sketch {tag}", sep, want[3], tol)
    del got, simt
    fused, bn = K.dense_act_sketch_x_route(HIDDEN, FFN, dt)
    route = ("fused x sketch from the ring" if fused else
             "kernel 2, then the separate sketch pass")
    _gemm_case(results, "dense_act_sketch_x", "forward", tag,
               K.fused_dense_act_sketch_x, K.dense_act_sketch_x_plain, xargs,
               errs, route, f"{K.FG_BM}x{bn}", 2 * N * HIDDEN * FFN, x, w)
    case = results["dense_act_sketch_x"][-1]
    case.update({
        "fused": fused, "bn": bn, "simt_errors": simt_errs,
        "simt_ms": cuda_ms(lambda: K.dense_act_sketch_x_simt(*xargs)),
        **device_time(lambda: K.dense_act_sketch_x_simt(*xargs),
                      case["bound_ms"], key="simt_device_ms")})
    log(f"kernel 2' [{tag}]: route {route}, BN {bn} "
        f"(dense_act_sketch_x_route({HIDDEN}, {FFN}))")
    log(f"kernel 2' [{tag}]: the CUDA-core kernel it replaced "
        f"(dense_act_sketch_x_simt) per call {case['simt_ms']:.4f} ms, "
        f"device {case['simt_device_ms']:.4f} ms, errors {simt_errs}; "
        f"kernel 2' per call {case['ms']:.4f} ms, device "
        f"{case['device_ms']:.4f} ms")
    # The separate pass alone: one multiply-add per element of x.
    least = bound(x.numel(), "simt", tensor_bytes(x, sigma_x, sep))
    case["input_sketch"] = {
        "error": sep_err,
        "ms": cuda_ms(lambda: K.input_sketch(x, sigma_x, K_EFF)),
        **device_time(lambda: K.input_sketch(x, sigma_x, K_EFF),
                      least["bound_ms"]),
        **least}
    c = case["input_sketch"]
    log(f"input_sketch [{tag}] ({N} x {HIDDEN}, k_eff {K_EFF}): error "
        f"{sep_err}, per call {c['ms']:.4f} ms, device {c['device_ms']:.4f} "
        f"ms, bound {c['bound_ms']:.4f} ms by {c['bound_by']}")
    ways = {"a": lambda: (K.fused_dense_act_sketch(*args),
                          K.countsketch_signed(x, sigma_x, K_EFF)),
            "b": lambda: (K.fused_dense_act_sketch(*args),
                          K.input_sketch(x, sigma_x, K_EFF)),
            "c": lambda: K.fused_dense_act_sketch_x(*xargs)}
    timed = {key: {"ms": [], "device_ms": []} for key in ways}
    for order in ("abc", "cba"):
        for key in order:
            timed[key]["ms"].append(cuda_ms(ways[key]))
            timed[key]["device_ms"].append(device_ms(ways[key],
                                                     case["bound_ms"]))
    case["ways"] = timed
    fastest = min(timed, key=lambda k: statistics.mean(timed[k]["ms"]))
    log(f"kernel 2' [{tag}] ways to (y, codes, sk_y, sk_x), two rounds in "
        f"turns abc, cba: (a) kernel 2 + countsketch_signed, (b) kernel 2 + "
        f"input_sketch, (c) kernel 2': {json.dumps(timed)}; fastest per "
        f"call: ({fastest})")


def _schedule_cases(results, spec, borders, x, up_w, up_b, z0):
    """The four tensor-core schedules of kernel 6 on the up projection
    (x, the (out, in) weight through .t(), the bias; ``z0`` the plain
    pre-activation), in every type pair that x's type admits, each against
    the one plain version.  Where a schedule's envelope refuses the shape
    (the resident f32 panel at K = 768) it is held at K = 128 instead, and
    that case is marked as not the path's shape."""
    from fewbit_tpu_torch.ops import kernels as K

    dt = x.dtype
    wrappers = {"dense_act_kloop": K.dense_act_kloop,
                "dense_act_direct": K.dense_act_direct,
                "dense_act_emit": K.dense_act_emit,
                "dense_act_pipelined": K.dense_act_pipelined}
    routes = {"dense_act_direct": K.dense_act_direct_route,
              "dense_act_emit": K.dense_act_emit_route}
    outs = [dt] if dt == torch.float32 else [torch.float32, dt]
    for name, wrapper in wrappers.items():
        for out_dt in outs:
            tag = ("f32" if dt == torch.float32 else
                   "bf16" if out_dt == dt else "bf16->f32")
            a, w, z, mode, path_shape = x, up_w.t(), z0, "forward", True
            if name in routes and routes[name](HIDDEN, FFN, dt,
                                               out_dt) is None:
                a = x[:, :128].contiguous()
                w = up_w[:, :128].contiguous().t()
                z = K.dot_f32(a, w) + up_b.float()
                mode = (f"forward at K = 128 (the panel of K = {HIDDEN} is "
                        f"outside the envelope)")
                path_shape = False
            args = (spec, a, w, up_b, borders, out_dt)
            y, packed = wrapper(*args)
            y0, packed0 = K.dense_act_plain(*args)
            flop = 2 * a.shape[0] * a.shape[1] * FFN
            errs = {"y": compare(f"{name} {tag} y", y, y0, TOL[out_dt]),
                    "code_flips": code_flips(f"{name} {tag}", packed,
                                             packed0, z, borders, spec.bits)}
            results[name].append({
                "mode": mode, "dtype": tag, "errors": errs,
                "path_shape": path_shape,
                "ms": cuda_ms(lambda: wrapper(*args)),
                "plain_ms": cuda_ms(lambda: K.dense_act_plain(*args)),
                **bound(flop, gemm_rate(dt), tensor_bytes(args, y, packed)),
                "library_ms": None})
            if name != "dense_act_kloop":
                continue
            # The k loop's ablation: z and one plane of zero words.
            z_got, zero = wrapper(*args, epilogue=False)
            z_want, zero0 = K.dense_act_plain(*args, epilogue=False)
            if not torch.equal(zero, zero0):
                raise AssertionError(f"{name} {tag}: ablation words not 0")
            results[name].append({
                "mode": "forward, no epilogue", "dtype": tag,
                "errors": {"z": compare(f"{name} {tag} z", z_got, z_want,
                                        TOL[out_dt])},
                "ms": cuda_ms(lambda: wrapper(*args, epilogue=False)),
                "plain_ms": cuda_ms(lambda: K.dense_act_plain(
                    *args, epilogue=False)),
                **bound(flop, gemm_rate(dt), tensor_bytes(args, z_got, zero)),
                "library_ms": None})


def _flash_backward_f64(q, k, v, ids, lse, do, di, causal, scale):
    """``(dk, dv, dq)`` by the plain formulas in f64, on the same inputs
    (the kernel's lse and di): what the kernels' and the plain versions'
    rounding is measured against."""
    from fewbit_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE

    q, k, v, do, lse, di = (t.double() for t in (q, k, v, do, lse, di))
    keep = (ids[:, :, None] == ids[:, None, :])[:, None]
    if causal:
        keep = keep.tril()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    del s, keep
    ds = (torch.einsum("bhqd,bhkd->bhqk", do, v) - di[..., None]) * p * scale
    return (torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", p, do),
            torch.einsum("bhqk,bhkd->bhqd", ds, k))


def _flash_forward_f64(q, k, v, ids, causal, scale):
    """``(o, lse)`` by the plain formulas in f64, on the same inputs."""
    from fewbit_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE

    q, k, v = (t.double() for t in (q, k, v))
    keep = (ids[:, :, None] == ids[:, None, :])[:, None]
    if causal:
        keep = keep.tril()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    del keep
    lse = torch.logsumexp(s, -1)
    return (torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                         v), lse)


def _nan_like(*like):
    """Outputs for a kernel to write into, full of NaN (integer ones with
    every bit set): an element it leaves unwritten cannot pass a
    comparison."""
    return tuple(torch.full_like(t, float("nan") if t.is_floating_point()
                                 else -1) for t in like)


def _held_to_f64(tag, names, got, simt, plain, want, tol):
    """Errors of a tensor-core kernel, the CUDA-core kernel it replaced and
    the plain version against the f64 evaluation ``want``, on its batch
    slice.  The tensor-core kernel sums in another order than f64 and on
    other units: an error of exactly 0 would mean the check cannot fail."""
    out = {}
    nb = want[0].shape[0]
    for name, g, s0, p0, w in zip(names, got, simt, plain, want):
        err = compare(f"{tag} {name} against f64", g[:nb], w, tol)
        if not err > 0:
            raise AssertionError(f"{tag} {name}: error against f64 is {err}")
        out[name] = {
            "kernel": err,
            "simt": compare(f"{tag} {name} CUDA-core kernel against f64",
                            s0[:nb], w, tol),
            "plain": compare(f"{tag} {name} plain against f64", p0[:nb], w,
                             tol),
            "simt_equals_plain": bool(torch.equal(s0, p0))}
    return out


def _flash_case(results, tag, shape, q, k, v, do, ids, causal, tol):
    """F1-F3 on one input against their plain versions (the backward ones
    on the kernel's lse and di, the same inputs), each timed, and each
    against an f64 evaluation of the plain formulas on a batch slice (with
    the plain versions' and the replaced CUDA-core kernels' errors beside),
    into outputs filled with NaN first, two launches held to equal bits, and
    beside the time of the CUDA-core kernel each replaced."""
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.ops.flash_attention import (
        flash_backward_dkv_plain, flash_backward_dq_plain,
        flash_forward_plain)

    scale = HEAD_DIM ** -0.5
    heads = q.shape[1]
    mode = f"{shape} {tuple(q.shape)}, {'causal' if causal else 'full'}"
    # The (q, k) pairs this input leaves unmasked, times heads: each costs
    # 2 d operations per product; F1 has two products, F2 four, F3 three.
    keep = ids[:, :, None] == ids[:, None, :]
    if causal:
        keep = keep.tril()
    pair_ops = 2 * HEAD_DIM * heads * int(keep.sum())
    lib = _sdpa_ms(q, k, v, do, keep, ids, causal, scale)
    del keep
    rate = gemm_rate(q.dtype)
    # The f64 evaluations, on as many batch rows as keep their (s, s)
    # tensors near 2^25 elements per head.
    nb = max(1, min(q.shape[0], 2 ** 25 // (heads * q.shape[2] ** 2)))
    fargs = (q, k, v, ids, ids, causal, scale)
    lse_like = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o, lse = K.flash_forward(*fargs, out=_nan_like(q, lse_like))
    o2, lse2 = K.flash_forward(*fargs, out=_nan_like(q, lse_like))
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"F1 {tag} {shape}: two launches differ")
    del o2, lse2
    if o.stride() != q.stride():
        raise AssertionError(f"F1 {tag}: o strides {o.stride()}")
    o0, lse0 = flash_forward_plain(*fargs)
    os_, lses = K.flash_forward_simt(*fargs)
    least = bound(2 * pair_ops, rate, tensor_bytes(q, k, v, ids, ids, o, lse))
    o64, lse64 = _flash_forward_f64(q[:nb], k[:nb], v[:nb], ids[:nb],
                                    causal, scale)
    results["flash_forward"].append({
        "mode": mode, "dtype": tag,
        "errors": {"o": compare(f"F1 {tag} {shape} o", o, o0, tol),
                   "lse": compare(f"F1 {tag} {shape} lse", lse, lse0, tol)},
        "f64_errors": _held_to_f64(f"F1 {tag} {shape}", ("o", "lse"),
                                   (o, lse), (os_, lses), (o0, lse0),
                                   (o64, lse64), tol),
        "f64_batch_rows": nb,
        "ms": cuda_ms(lambda: K.flash_forward(*fargs)),
        **device_time(lambda: K.flash_forward(*fargs), least["bound_ms"]),
        "plain_ms": cuda_ms(lambda: flash_forward_plain(*fargs)),
        # The CUDA-core kernel it replaced, same inputs, same call.
        "simt_ms": cuda_ms(lambda: K.flash_forward_simt(*fargs)),
        **least,
        "library_ms": lib["fwd_ms"], "library_device_ms": lib["fwd_device_ms"],
        "library": "scaled_dot_product_attention, forward"})
    del o0, lse0, os_, lses, o64, lse64
    di = (o.float() * do.float()).sum(-1)
    bargs = (q, k, v, ids, ids, lse, do, di, causal, scale)
    dk64, dv64, dq64 = _flash_backward_f64(
        q[:nb], k[:nb], v[:nb], ids[:nb], lse[:nb], do[:nb], di[:nb], causal,
        scale)
    library = ("scaled_dot_product_attention, backward: dq, dk and dv in "
               "one call (F2 and F3 together)")
    dk, dv = K.flash_backward_dkv(*bargs, out=_nan_like(k, v))
    dk2, dv2 = K.flash_backward_dkv(*bargs, out=_nan_like(k, v))
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"F2 {tag} {shape}: two launches differ")
    del dk2, dv2
    dk0, dv0 = flash_backward_dkv_plain(*bargs)
    dks, dvs = K.flash_backward_dkv_simt(*bargs)
    least = bound(4 * pair_ops, rate,
                  tensor_bytes(q, k, v, ids, ids, lse, do, di, dk, dv))
    case = {
        "mode": mode, "dtype": tag,
        "errors": {"dk": compare(f"F2 {tag} {shape} dk", dk, dk0, tol),
                   "dv": compare(f"F2 {tag} {shape} dv", dv, dv0, tol)},
        "f64_errors": _held_to_f64(f"F2 {tag} {shape}", ("dk", "dv"),
                                   (dk, dv), (dks, dvs), (dk0, dv0),
                                   (dk64, dv64), tol),
        "f64_batch_rows": nb,
        "ms": cuda_ms(lambda: K.flash_backward_dkv(*bargs)),
        **device_time(lambda: K.flash_backward_dkv(*bargs),
                      least["bound_ms"]),
        "plain_ms": cuda_ms(lambda: flash_backward_dkv_plain(*bargs)),
        # The CUDA-core kernel it replaced, same inputs, same call.
        "simt_ms": cuda_ms(lambda: K.flash_backward_dkv_simt(*bargs)),
        **least,
        "library_ms": lib["bwd_ms"], "library_device_ms": lib["bwd_device_ms"],
        "library": library}
    results["flash_backward_dkv"].append(case)
    del dk0, dv0, dks, dvs, dk64, dv64
    dq = K.flash_backward_dq(*bargs, out=_nan_like(q))
    if not torch.equal(dq, K.flash_backward_dq(*bargs, out=_nan_like(q))):
        raise AssertionError(f"F3 {tag} {shape}: two launches differ")
    dq0 = flash_backward_dq_plain(*bargs)
    dqs = K.flash_backward_dq_simt(*bargs)
    least = bound(3 * pair_ops, rate,
                  tensor_bytes(q, k, v, ids, ids, lse, do, di, dq))
    results["flash_backward_dq"].append({
        "mode": mode, "dtype": tag,
        "errors": {"dq": compare(f"F3 {tag} {shape} dq", dq, dq0, tol)},
        "f64_errors": _held_to_f64(f"F3 {tag} {shape}", ("dq",), (dq,),
                                   (dqs,), (dq0,), (dq64,), tol),
        "f64_batch_rows": nb,
        "ms": cuda_ms(lambda: K.flash_backward_dq(*bargs)),
        **device_time(lambda: K.flash_backward_dq(*bargs),
                      least["bound_ms"]),
        "plain_ms": cuda_ms(lambda: flash_backward_dq_plain(*bargs)),
        "simt_ms": cuda_ms(lambda: K.flash_backward_dq_simt(*bargs)),
        **least,
        "library_ms": lib["bwd_ms"], "library_device_ms": lib["bwd_device_ms"],
        "library": library})
    if shape == "gpt2_small":
        for name in ("flash_forward", "flash_backward_dkv",
                     "flash_backward_dq"):
            c = results[name][-1]
            if not c["ms"] <= c["simt_ms"]:
                raise AssertionError(
                    f"{name} {tag}: the tensor-core kernel takes {c['ms']} "
                    f"ms, the CUDA-core kernel it replaced {c['simt_ms']} ms")


def _sdpa_ms(q, k, v, do, keep, ids, causal, scale):
    """Milliseconds of PyTorch's ``scaled_dot_product_attention`` on the
    flash kernels' inputs, forward and backward (dq, dk and dv in one
    call): the library's time for the same function.  A yardstick only:
    the port never calls it.  All-ones segment ids with ``causal`` are its
    ``is_causal``; any other mask is passed as a boolean ``attn_mask``.
    Returns the forward's and the backward's time per call and on the
    device (the profiler's)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if causal and bool((ids == 1).all()):
        kwargs = {"is_causal": True}
    else:
        kwargs = {"attn_mask": keep[:, None]}
    ins = [t.detach().requires_grad_() for t in (q, k, v)]

    def forward():
        with torch.no_grad():
            return sdpa(*ins, scale=scale, **kwargs)

    out = sdpa(*ins, scale=scale, **kwargs)

    def backward():
        torch.autograd.grad(out, ins, do, retain_graph=True)

    return {"fwd_ms": cuda_ms(forward), "fwd_device_ms": device_ms(forward),
            "bwd_ms": cuda_ms(backward), "bwd_device_ms": device_ms(backward)}


def phase_kernels():
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.train import synthetic_glue

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec, borders, levels = resolve_activation("gelu", bits=3, device=dev)
    results = {name: [] for name in K.KERNELS}

    def rand(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    sigma, sigma_x = (torch.randint(0, 2, (N,), generator=gen,
                                    device=dev).float() * 2 - 1
                      for _ in range(2))
    # Segment ids as the models pass them: GPT's all-ones mask, RoBERTa's
    # MRPC-shaped padding mask.
    gpt_ids = torch.ones(GPT_BS, GPT_SEQ, dtype=torch.int32, device=dev)
    mrpc_ids = torch.from_numpy(next(synthetic_glue(BS, SEQ, seed=SEED))[
        "attention_mask"]).to(device=dev, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        tag = "f32" if dt == torch.float32 else "bf16"
        # Kernel 1, forward mode: an attention projection on x, the weight
        # an (out, in) parameter seen through .t().
        x = rand(N, HIDDEN, dt=dt)
        weight = rand(HIDDEN, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
        bias = rand(HIDDEN, scale=0.1, dt=dt)
        _k1_case(results, "forward", tag, ("y", "sketch"),
                 (x, weight.t(), bias, sigma, K_EFF), tol)
        # Kernel 1, backward mode: dy @ w with the column sum for db.
        g = rand(N, HIDDEN, dt=dt)
        _k1_case(results, "backward+colsum", tag, ("dx", "sketch", "colsum"),
                 (g, weight, None, sigma, K_EFF, True), tol)

        # Kernel 2: the FFN up projection with GELU, codes and sketch(y).
        up_w = rand(FFN, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
        up_b = rand(FFN, scale=0.1, dt=dt)
        args = (spec, x, up_w.t(), up_b, borders, sigma, K_EFF)
        y, packed, sk = K.fused_dense_act_sketch(*args)
        y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
        z0 = K.dot_f32(x, up_w.t()) + up_b.float()
        errs = {"y": compare(f"k2 {tag} y", y, y0, tol),
                "sketch": compare(f"k2 {tag} sketch", sk, sk0, tol),
                "code_flips": code_flips(f"k2 {tag}", packed, packed0, z0,
                                         borders, spec.bits)}
        ffn_flop = 2 * N * HIDDEN * FFN
        _ffn_case(results, "dense_act_sketch", "forward", tag,
                  K.fused_dense_act_sketch, K.dense_act_sketch_plain, args,
                  errs, x, up_w.t())

        # Kernel 2': kernel 2 that also sketches x (sum of N / k_eff = 4
        # rows per bucket), on the route dense_act_sketch_x_route gives,
        # into outputs filled first, two launches equal to the bit.
        _sketch_x_case(results, spec, borders, args, sigma_x, z0, tag, tol)

        # Kernel 3: the FFN backward on kernel 2's codes, with the down
        # projection's (out, in) weight as wt.
        down_w = rand(HIDDEN, FFN, scale=FFN ** -0.5, dt=dt)
        args = (spec, packed, levels, g, down_w, sigma, K_EFF)
        dz, sk, db = K.fused_matmul_lut_backward(*args)
        dz0, sk0, db0 = K.matmul_lut_backward_plain(*args)
        errs = {"dz": compare(f"k3 {tag} dz", dz, dz0, tol),
                "sketch": compare(f"k3 {tag} sketch", sk, sk0, tol),
                "db": compare(f"k3 {tag} db", db, db0, TOL_SUM)}
        _ffn_case(results, "matmul_lut_backward", "backward", tag,
                  K.fused_matmul_lut_backward, K.matmul_lut_backward_plain,
                  args, errs, g, down_w)

        # Kernel 6: the GPT FFN up projection with GELU and codes, no
        # sketch, the weight an (out, in) parameter seen through .t().
        args = (spec, x, up_w.t(), up_b, borders)
        y, packed6 = K.fused_dense_act(*args)
        y0, packed0 = K.dense_act_plain(*args)
        errs = {"y": compare(f"k6 {tag} y", y, y0, tol),
                "code_flips": code_flips(f"k6 {tag}", packed6, packed0, z0,
                                         borders, spec.bits)}
        case = {
            "mode": f"forward, the {K.dense_act_schedule(N, FFN, dt)} "
                    f"schedule", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_dense_act(*args)),
            "plain_ms": cuda_ms(lambda: K.dense_act_plain(*args)),
            # The CUDA-core kernel it replaced, same inputs, same call.
            "simt_ms": cuda_ms(lambda: K.dense_act_simt(*args)),
            **bound(ffn_flop, gemm_rate(dt), tensor_bytes(args, y, packed6)),
            "library_ms": None}
        if not case["ms"] <= case["simt_ms"]:
            raise AssertionError(f"k6 {tag}: the shipped kernel takes "
                                 f"{case['ms']} ms, the CUDA-core kernel "
                                 f"{case['simt_ms']} ms")
        results["dense_act"].append(case)
        _schedule_cases(results, spec, borders, x, up_w, up_b, z0)

        # Kernel 4: the RoBERTa unfused FFN's GELU on the (N, FFN)
        # pre-activation.  Its codes are the plain version's exactly: the
        # same f32 compares of the same x.
        h = rand(N, FFN, scale=1.5, dt=dt)
        args = (spec, h, borders)
        y, packed4 = K.fused_forward(*args)
        y0, packed0 = K.act_forward_plain(*args)
        if not torch.equal(packed4, packed0):
            raise AssertionError(f"k4 {tag}: packed codes differ")
        errs = {"y": compare(f"k4 {tag} y", y, y0, tol), "code_flips": 0}
        # Per element: one compare per border and the GELU, on CUDA cores.
        least = bound(h.numel() * (spec.n_borders + 1), "simt",
                      tensor_bytes(args, y, packed4))
        case = {
            "mode": "forward", "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_forward(*args)),
            **device_time(lambda: K.fused_forward(*args), least["bound_ms"]),
            "plain_ms": cuda_ms(lambda: K.act_forward_plain(*args)),
            **least,
            "library_ms": None}
        case["bound_share"] = case["bound_ms"] / case["device_ms"]
        results["fused_forward"].append(case)

        # Kernel 5 on the codes of kernel 6 (GPT) and of kernel 4 (RoBERTa
        # unfused), with an (N, FFN) output gradient.
        g_ffn = rand(N, FFN, dt=dt)
        for source, packed in (("codes of kernel 6", packed6),
                               ("codes of kernel 4", packed4)):
            args = (spec, packed, levels, g_ffn)
            dx = K.fused_backward(*args)
            dx0 = K.act_backward_plain(*args)
            # Per element: one multiply, on CUDA cores.
            least = bound(g_ffn.numel(), "simt", tensor_bytes(args, dx))
            case = {
                "mode": f"backward on {source}", "dtype": tag,
                "errors": {"dx": compare(f"k5 {tag} {source}", dx, dx0,
                                         tol)},
                "ms": cuda_ms(lambda: K.fused_backward(*args)),
                **device_time(lambda: K.fused_backward(*args),
                              least["bound_ms"]),
                "plain_ms": cuda_ms(lambda: K.act_backward_plain(*args)),
                **least,
                "library_ms": None}
            case["bound_share"] = case["bound_ms"] / case["device_ms"]
            results["fused_backward"].append(case)

        _tp_width_cases(results, spec, borders, levels, sigma, x, g, rand,
                        tag, tol)
        # F1-F3 at both paths' shapes, on (b, s, h, d) projections seen
        # through transpose(1, 2), as the models pass them; and at one
        # tp=2 rank's 6 local heads, (b, s, 6, d) views of its (b, s, 384)
        # projection.
        for shape, b, s, causal, ids, heads in (
                ("gpt2_small", GPT_BS, GPT_SEQ, True, gpt_ids, HEADS),
                ("roberta", BS, SEQ, False, mrpc_ids, HEADS),
                ("gpt2_small tp=2 local heads", GPT_BS, GPT_SEQ, True,
                 gpt_ids, HEADS // TP),
                ("roberta tp=2 local heads", BS, SEQ, False, mrpc_ids,
                 HEADS // TP)):
            q, k, v, do = (rand(b, s, heads, HEAD_DIM, dt=dt).transpose(1, 2)
                           for _ in range(4))
            _flash_case(results, tag, shape, q, k, v, do, ids, causal, tol)
        torch.cuda.empty_cache()
    _log_cases(results)
    return results


def _log_cases(results):
    """One line per kernel case: its errors, times and bound."""
    for name, cases in results.items():
        for c in cases:
            extra = (f"; bound {c['bound_ms']:.4f} ms by {c['bound_by']} "
                     f"({c['ops'] / 1e9:.2f} G operations, "
                     f"{c['bytes'] / 1e6:.1f} MB)")
            if c["library_ms"] is not None:
                extra += (f"; library {c['library_ms']:.3f} ms "
                          f"({c['library']})")
            if "simt_ms" in c:
                extra += (f"; the CUDA-core kernel it replaced "
                          f"{c['simt_ms']:.3f} ms")
            if "simt_device_ms" in c:
                extra += f" ({c['simt_device_ms']:.4f} ms device)"
            if "f64_errors" in c:
                extra += (f"; device {c['device_ms']:.4f} ms "
                          f"({100 * c['bound_ms'] / c['device_ms']:.1f}% of "
                          f"the bound), the library's "
                          f"{c['library_device_ms']:.4f} ms device; against "
                          f"f64 on {c['f64_batch_rows']} batch rows: "
                          f"{c['f64_errors']}")
            if "bound_share" in c and "route" not in c:
                extra += (f"; device {c['device_ms']:.4f} ms "
                          f"({100 * c['bound_share']:.1f}% of the bound)")
            if "route" in c:
                extra += (f"; {c['route']}, tile {c['tile']}; device "
                          f"{c['device_ms']:.4f} ms ({c['tflops']:.1f} "
                          f"TFLOP/s, {100 * c['bound_share']:.1f}% of the "
                          f"bound), plain {c['plain_device_ms']:.4f} ms "
                          f"({c['plain_tflops']:.1f} TFLOP/s); context, not "
                          f"the same function: torch.matmul of the product "
                          f"alone {c['matmul_only_device_ms']:.4f} ms device")
            events = [k[:-len("_source")] for k, v in c.items()
                      if k.endswith("_source") and v == "events"]
            if events:
                extra += (f"; {', '.join(events)} by CUDA events (every "
                          f"profiled run below the bound)")
            log(f"kernel {name} [{c['mode']}, {c['dtype']}]: errors "
                f"{c['errors']}, kernel {c['ms']:.3f} ms, plain "
                f"{c['plain_ms']:.3f} ms (calls){extra}")


# Tensor parallelism at tp=2: each rank's slice of RoBERTa-base and GPT-2
# small (the parallel phase).
TP = 2
TP_WIDTH, TP_INNER = HIDDEN // TP, FFN // TP   # 384, 1536


def _tp_width_cases(results, spec, borders, levels, sigma, x, g, rand, tag,
                    tol):
    """The kernels of the tp=2 paths at one rank's widths, each into
    outputs filled with NaN against its plain version, with its device
    time and share of the bound: kernel 1 at 768 -> 384 (query, key,
    value; with bias) and 384 -> 768 (output; no bias, added after the
    all-reduce), forward and backward with the column sum; kernels 2 and
    3 at 768 <-> 1536; kernel 6 at 768 -> 1536 and kernel 5 on its codes
    at (8192, 1536)."""
    from fewbit_tpu_torch.ops import kernels as K

    dt = x.dtype
    w_col = rand(TP_WIDTH, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
    b_col = rand(TP_WIDTH, scale=0.1, dt=dt)
    ctx, g_col = rand(N, TP_WIDTH, dt=dt), rand(N, TP_WIDTH, dt=dt)
    w_row = rand(HIDDEN, TP_WIDTH, scale=TP_WIDTH ** -0.5, dt=dt)
    for mode, args in (
            ("tp=2 forward 768->384", (x, w_col.t(), b_col, sigma, K_EFF)),
            ("tp=2 forward 384->768", (ctx, w_row.t(), None, sigma, K_EFF)),
            ("tp=2 backward+colsum 384->768",
             (g_col, w_col, None, sigma, K_EFF, True)),
            ("tp=2 backward+colsum 768->384",
             (g, w_row, None, sigma, K_EFF, True))):
        names = ("dx", "sketch", "colsum") if len(args) == 6 else ("y",
                                                                 "sketch")
        _k1_case(results, mode, tag, names, args, tol)

    up_w = rand(TP_INNER, HIDDEN, scale=HIDDEN ** -0.5, dt=dt)
    up_b = rand(TP_INNER, scale=0.1, dt=dt)
    down_w = rand(HIDDEN, TP_INNER, scale=TP_INNER ** -0.5, dt=dt)
    _k23_cases(results, spec, borders, levels, sigma, K_EFF, x, g, up_w,
               up_b, down_w, tag, tol, "tp=2")
    packed6 = _k6_case(results, spec, borders, x, up_w, up_b, tag, tol,
                       "tp=2")
    _k5_case(results, spec, levels, packed6, rand(N, TP_INNER, dt=dt), tag,
             tol, "tp=2", "codes of kernel 6")


def _k23_cases(results, spec, borders, levels, sigma, k_eff, x, g, up_w,
               up_b, down_w, tag, tol, label):
    """Kernel 2 at ``x @ up_w.t() + up_b`` and kernel 3 on its codes with
    the output gradient ``g`` through ``down_w``, each into outputs filled
    with NaN against its plain version, with its device time and share of
    the bound; ``label`` starts the cases' modes."""
    from fewbit_tpu_torch.ops import kernels as K

    (n, kdim), m = x.shape, up_w.shape[0]
    z0 = K.dot_f32(x, up_w.t()) + up_b.float()
    args = (spec, x, up_w.t(), up_b, borders, sigma, k_eff)
    want = K.dense_act_sketch_plain(*args)
    y, packed, sk = K.fused_dense_act_sketch(*args, out=_nan_like(*want))
    errs = {"y": compare(f"k2 {label} {tag} y", y, want[0], tol),
            "sketch": compare(f"k2 {label} {tag} sketch", sk, want[2], tol),
            "code_flips": code_flips(f"k2 {label} {tag}", packed, want[1],
                                     z0, borders, spec.bits)}
    _ffn_case(results, "dense_act_sketch", f"{label} forward {kdim}->{m}",
              tag, K.fused_dense_act_sketch, K.dense_act_sketch_plain, args,
              errs, x, up_w.t())
    args = (spec, packed, levels, g, down_w, sigma, k_eff)
    want = K.matmul_lut_backward_plain(*args)
    got = K.fused_matmul_lut_backward(*args, out=_nan_like(*want))
    errs = {name: compare(f"k3 {label} {tag} {name}", a, b,
                          TOL_SUM if name == "db" else tol)
            for name, a, b in zip(("dz", "sketch", "db"), got, want)}
    _ffn_case(results, "matmul_lut_backward",
              f"{label} backward {kdim}->{m}", tag,
              K.fused_matmul_lut_backward, K.matmul_lut_backward_plain, args,
              errs, g, down_w)


def _k6_case(results, spec, borders, x, up_w, up_b, tag, tol, label):
    """Kernel 6 at ``x @ up_w.t() + up_b`` into outputs filled with NaN
    against its plain version, with its device time and share of the
    bound.  Returns its codes."""
    from fewbit_tpu_torch.ops import kernels as K

    (n, kdim), m = x.shape, up_w.shape[0]
    z0 = K.dot_f32(x, up_w.t()) + up_b.float()
    args = (spec, x, up_w.t(), up_b, borders)
    want = K.dense_act_plain(*args)
    y, packed6 = K.fused_dense_act(*args, out=_nan_like(*want))
    errs = {"y": compare(f"k6 {label} {tag} y", y, want[0], tol),
            "code_flips": code_flips(f"k6 {label} {tag}", packed6, want[1],
                                     z0, borders, spec.bits)}
    least = bound(2 * n * kdim * m, gemm_rate(x.dtype),
                  tensor_bytes(args, y, packed6))
    case = {"mode": f"{label} forward {kdim}->{m}, the "
                    f"{K.dense_act_schedule(n, m, x.dtype)} schedule",
            "dtype": tag, "errors": errs,
            "ms": cuda_ms(lambda: K.fused_dense_act(*args)),
            **device_time(lambda: K.fused_dense_act(*args),
                          least["bound_ms"]),
            "plain_ms": cuda_ms(lambda: K.dense_act_plain(*args)),
            **least,
            "library_ms": None}
    case["bound_share"] = case["bound_ms"] / case["device_ms"]
    results["dense_act"].append(case)
    return packed6


def _k5_case(results, spec, levels, packed, g_ffn, tag, tol, label, source):
    """Kernel 5 on ``packed`` (the codes of ``source``) with the output
    gradient ``g_ffn``, into an output filled with NaN against its plain
    version, with its device time and share of the bound."""
    from fewbit_tpu_torch.ops import kernels as K

    args = (spec, packed, levels, g_ffn)
    want = K.act_backward_plain(*args)
    dx = K.fused_backward(*args, out=_nan_like(want))
    # Per element: one multiply, on CUDA cores.
    least = bound(g_ffn.numel(), "simt", tensor_bytes(args, dx))
    case = {"mode": f"{label} backward {tuple(g_ffn.shape)} on {source}",
            "dtype": tag,
            "errors": {"dx": compare(f"k5 {label} {tag}", dx, want, tol)},
            "ms": cuda_ms(lambda: K.fused_backward(*args)),
            **device_time(lambda: K.fused_backward(*args),
                          least["bound_ms"]),
            "plain_ms": cuda_ms(lambda: K.act_backward_plain(*args)),
            **least,
            "library_ms": None}
    case["bound_share"] = case["bound_ms"] / case["device_ms"]
    results["fused_backward"].append(case)


# The activation phase: every id of ACT_IDS but stepwise with its default
# arguments (3-bit builtin LUT for the continuous ones), the ids that take
# arguments once more with others (in bf16 not all of them bf16 numbers),
# and stepwise by parity, with and without a shift, a 5-level LUT among
# them and a 6-bit one.
ACT_OTHER_ARGS = {"hardshrink": (0.3,), "hardtanh": (-0.7, 0.3),
                  "leaky_relu": (0.1,), "softshrink": (0.3,),
                  "threshold": (0.3, -0.2), "celu": (0.5,), "elu": (1.5,),
                  "softplus": (2.0, 5.0)}
STEPWISE_CASES = {
    "none": ([-1.0, 0.0, 0.7, 1.4], [0.1, 0.3, 0.5, 0.7, 0.9], None, None),
    "none+shift": ([-1.0, 0.0, 0.7, 1.4], [0.1, 0.3, 0.5, 0.7, 0.9], None,
                   (0.1, 0.5)),
    "even": ([0.4, 0.8, 1.6], [1.0, 0.6, 0.3, 0.1], False, None),
    "even+shift": ([0.4, 0.8, 1.6], [1.0, 0.6, 0.3, 0.1], False,
                   (-0.2, 0.0)),
    "odd": ([0.3, 0.9, 1.6, 2.4], [1.0, 0.8, 0.5, 0.2, 0.05], True, None),
    "odd+shift": ([0.3, 0.9, 1.6, 2.4], [1.0, 0.8, 0.5, 0.2, 0.05], True,
                  (0.1, 0.25)),
    "odd 6-bit": (np.linspace(0.1, 3.1, 31), np.linspace(1.0, 0.0, 32),
                  True, None),
}
# Kernel 6's loop and kernel 2 timed for these ids (besides holding all).
ACT_TIMED_K6, ACT_TIMED_K2 = ("gelu", "relu", "silu", "mish"), ("gelu",
                                                                 "silu")
# FewBitFFN launches on the activation path: relu and silu, one forward and
# backward each.
FFN_ACTS = ("relu", "silu")


def _act_cases(dev):
    """(tag, spec, borders, levels) of every activation case."""
    from fewbit_tpu_torch.functional.activations import (resolve_activation,
                                                         stepwise_triple)
    from fewbit_tpu_torch.ops.activations import ACT_IDS

    for name in ACT_IDS:
        if name != "stepwise":
            yield (name, *resolve_activation(name, device=dev))
        if name in ACT_OTHER_ARGS:
            yield (f"{name}{ACT_OTHER_ARGS[name]}",
                   *resolve_activation(name, args=ACT_OTHER_ARGS[name],
                                       device=dev))
    for tag, (b, v, parity, shift) in STEPWISE_CASES.items():
        yield (f"stepwise {tag}",
               *stepwise_triple(b, v, parity, shift, device=dev))


def _code_borders(spec, borders):
    """Where a code may flip under a different rounding of z: the borders,
    or a predicate's thresholds."""
    from fewbit_tpu_torch.ops.activations import kernel_args

    if spec.code != "predicate":
        return borders
    _, _, _, _, lo, hi, on_abs, _, _ = kernel_args(spec, torch.float32)
    edges = [lo] + ([hi] if np.isfinite(hi) else []) + ([-lo] if on_abs
                                                        else [])
    return torch.tensor(edges, device=borders.device)


def _fwd_jumps(spec):
    """Where the forward jumps: hardshrink and threshold at their
    thresholds, softplus where z * beta meets its threshold.  Where the
    kernel's z and the plain z lie on either side of one within rounding,
    y takes either side, as a code does at a border."""
    a = spec.args
    if spec.name == "hardshrink":
        return [a[0], -a[0]]
    if spec.name == "threshold":
        return [a[0]]
    return [a[1] / a[0]] if spec.name == "softplus" else []


def compare_y(tag, y, y0, z0, spec, tol):
    """``compare`` outside FLIP_BAND of the forward's jumps; within it y
    may differ (either side of the jump) on at most FLIP_FRACTION of the
    elements."""
    near = torch.zeros_like(z0, dtype=torch.bool)
    for edge in _fwd_jumps(spec):
        near |= (z0 - edge).abs() <= FLIP_BAND
    scale = max(1.0, y0.float().abs().max().item())
    jumped = near & ((y.float() - y0.float()).abs() > tol * scale)
    if jumped.sum().item() > FLIP_FRACTION * near.numel():
        raise AssertionError(f"{tag}: y differs across a jump of the "
                             f"forward at {jumped.sum().item()} elements")
    return compare(tag, y[~near], y0[~near], tol)


def phase_activations():
    """Every activation id through kernels 4 and 5 at the MLP tower's
    (8192, 3072), and every id but stepwise through kernel 6 (its scheduled
    route) and 5 at 8192 x 768 -> 3072, each against its plain version in
    f32 and bf16: codes equal (kernel 4) or flipped only within FLIP_BAND
    of a border or threshold (kernel 6), dx equal to the bit, y within TOL
    (for kernel 6 outside FLIP_BAND of a jump of the forward).
    Kernels 2, 2' (its route and its CUDA-core kernel) and 3 for relu and
    silu at the FFN shape against their plain versions; then the path:
    ``FewBitFFN(768, 3072, 768, activation=...)`` at N = 8192, forward
    (equal to the exact block within TOL) and backward, with the counts at
    0 just before and read just after (its launches stay in the returned
    summary, apart from the training paths' counts)."""
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.modules import FewBitFFN
    from fewbit_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {"fused_forward": {}, "dense_act": {}, "dense_act_sketch": {},
           "flips": {}}
    sigma, sigma_x = (torch.randint(0, 2, (N,), generator=gen,
                                    device=dev).float() * 2 - 1
                      for _ in range(2))
    cases = list(_act_cases(dev))
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        tag = "f32" if dt == torch.float32 else "bf16"
        h = (torch.randn(N, FFN, generator=gen, device=dev) * 2.5).to(dt)
        g = torch.randn(N, FFN, generator=gen, device=dev).to(dt)
        for name, spec, borders, levels in cases:
            y, packed = K.fused_forward(spec, h, borders)
            y0, packed0 = K.act_forward_plain(spec, h, borders)
            if not torch.equal(packed, packed0):
                raise AssertionError(f"k4 {name} {tag}: codes differ")
            compare(f"k4 {name} {tag} y", y, y0, tol)
            dx = K.fused_backward(spec, packed, levels, g)
            if not torch.equal(dx, K.act_backward_plain(spec, packed,
                                                        levels, g)):
                raise AssertionError(f"k5 {name} {tag}: dx differs")
            out["fused_forward"][f"{name} {tag}"] = device_ms(
                lambda: K.fused_forward(spec, h, borders), bound(
                    h.numel() * (spec.n_borders + 1), "simt",
                    tensor_bytes(h, borders, y, packed))["bound_ms"])
        del h, g, y, y0, dx
        x = torch.randn(N, HIDDEN, generator=gen, device=dev).to(dt)
        w = (torch.randn(FFN, HIDDEN, generator=gen, device=dev)
             * HIDDEN ** -0.5).to(dt)
        b = (torch.randn(FFN, generator=gen, device=dev) * 0.1).to(dt)
        g = torch.randn(N, FFN, generator=gen, device=dev).to(dt)
        z0 = K.dot_f32(x, w.t()) + b.float()
        for name, spec, borders, levels in cases:
            if spec.code == "stepwise":
                continue
            args = (spec, x, w.t(), b, borders)
            y, packed = K.fused_dense_act(*args)
            y0, packed0 = K.dense_act_plain(*args)
            compare_y(f"k6 {name} {tag} y", y, y0, z0, spec, tol)
            out["flips"][f"k6 {name} {tag}"] = code_flips(
                f"k6 {name} {tag}", packed, packed0, z0,
                _code_borders(spec, borders), spec.bits)
            dz = K.fused_backward(spec, packed, levels, g)
            if not torch.equal(dz, K.act_backward_plain(spec, packed,
                                                        levels, g)):
                raise AssertionError(f"k5 on k6 {name} {tag}: dz differs")
            if name in ACT_TIMED_K6:
                least = bound(2 * N * HIDDEN * FFN, gemm_rate(dt),
                              tensor_bytes(args, y, packed))["bound_ms"]
                out["dense_act"][f"{name} {tag}"] = {
                    **device_time(lambda: K.dense_act_kloop(*args), least,
                                  key="loop_device_ms"),
                    "schedule": K.dense_act_schedule(N, FFN, dt),
                    **device_time(lambda: K.fused_dense_act(*args), least)}
            if name not in FFN_ACTS + ACT_TIMED_K2:
                continue
            args = (spec, x, w.t(), b, borders, sigma, K_EFF)
            y, packed, sk = K.fused_dense_act_sketch(*args)
            y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
            compare(f"k2 {name} {tag} y", y, y0, tol)
            compare(f"k2 {name} {tag} sketch", sk, sk0, tol)
            out["flips"][f"k2 {name} {tag}"] = code_flips(
                f"k2 {name} {tag}", packed, packed0, z0,
                _code_borders(spec, borders), spec.bits)
            down = (torch.randn(HIDDEN, FFN, generator=gen, device=dev)
                    * FFN ** -0.5).to(dt)
            gh = torch.randn(N, HIDDEN, generator=gen, device=dev).to(dt)
            args3 = (spec, packed, levels, gh, down, sigma, K_EFF)
            got, want = (K.fused_matmul_lut_backward(*args3),
                         K.matmul_lut_backward_plain(*args3))
            for what, a, r, t in zip(("dz", "sketch", "db"), got, want,
                                     (tol, tol, TOL_SUM)):
                compare(f"k3 {name} {tag} {what}", a, r, t)
            if name in ACT_TIMED_K2:
                out["dense_act_sketch"][f"{name} {tag}"] = device_ms(
                    lambda: K.fused_dense_act_sketch(*args), bound(
                        2 * N * HIDDEN * FFN, gemm_rate(dt),
                        tensor_bytes(args, y, packed, sk))["bound_ms"])
            if name not in FFN_ACTS:
                continue
            # Kernel 2' (its route at this shape, and its CUDA-core
            # kernel): y, codes and both sketches.
            xargs = args + (sigma_x,)
            want = K.dense_act_sketch_x_plain(*xargs)
            for way, fn in (("k2'", K.fused_dense_act_sketch_x),
                            ("k2' simt", K.dense_act_sketch_x_simt)):
                got = fn(*xargs)
                for what, a, r in zip(("y", "sketch_y", "sketch_x"),
                                      got[:1] + got[2:], want[:1] + want[2:]):
                    compare(f"{way} {name} {tag} {what}", a, r, tol)
                out["flips"][f"{way} {name} {tag}"] = code_flips(
                    f"{way} {name} {tag}", got[1], want[1], z0,
                    _code_borders(spec, borders), spec.bits)
            del got, want
        del x, w, b, g, z0
        torch.cuda.empty_cache()
    # The path: FewBitFFN with a non-GELU activation, through kernels 2
    # and 3 and no plain path.
    x = torch.randn(BS, SEQ, HIDDEN, generator=gen, device=dev)
    K.reset_launch_counts()
    ffn_out = {}
    for name in FFN_ACTS:
        mod = FewBitFFN(HIDDEN, FFN, HIDDEN, activation=name,
                        proj_dim_ratio=0.2, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        xr = x.clone().requires_grad_()
        y = mod(xr, torch.Generator(device=dev).manual_seed(2))
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
        with torch.no_grad():
            spec = resolve_activation(name)[0]
            z = x.reshape(N, HIDDEN) @ mod.up_weight.t() + mod.up_bias
            want = (spec.fwd(z, spec.args) @ mod.down_weight.t()
                    + mod.down_bias).reshape(y.shape)
        err = compare(f"FewBitFFN {name} forward", y, want, TOL_SUM)
        if not torch.isfinite(xr.grad).all():
            raise AssertionError(f"FewBitFFN {name}: dx not finite")
        ffn_out[name] = {"forward_err": err,
                         "dx_norm": xr.grad.norm().item()}
    counts = K.launch_counts()
    expected = {k: 0 for k in counts}
    expected.update(dense_act_sketch=len(FFN_ACTS),
                    matmul_lut_backward=len(FFN_ACTS))
    if counts != expected:
        raise AssertionError(f"FewBitFFN activations: launches {counts}, "
                             f"expected {expected}")
    out["ffn"] = ffn_out
    out["ffn_launches"] = {k: v for k, v in counts.items() if v}
    log(f"activations, kernel 4 device ms per id at ({N}, {FFN}): "
        f"{json.dumps(out['fused_forward'])}")
    log(f"activations, kernel 6 at {N} x {HIDDEN} -> {FFN}, device ms: "
        f"{json.dumps(out['dense_act'])}")
    log(f"activations, kernel 2 at {N} x {HIDDEN} -> {FFN}, device ms: "
        f"{json.dumps(out['dense_act_sketch'])}")
    log(f"activations, code flips of kernels 6, 2 and 2' against plain: "
        f"{json.dumps(out['flips'])}")
    log(f"activations, FewBitFFN path: {json.dumps(ffn_out)}; launches "
        f"{out['ffn_launches']}")
    return out


def _standard_attention(q, k, v, mask, scale):
    """The models' standard causal attention on (b, s, h, d) projections,
    the probabilities in v's type."""
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    keep = (torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            [None, None] & (mask[:, None, None, :] > 0))
    logits = logits + torch.where(keep, 0.0, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def phase_crossover():
    """Attention forward and backward, causal, 8192 tokens, f32 and bf16:
    the flash op (F1, then F2 and F3) against the standard attention, at
    seq 128, 256, 512 and 1024 -- the card's own crossover for
    ``flash_attention="auto"`` (printed, not acted on)."""
    from fewbit_tpu_torch.ops.flash_attention import (SegmentIds,
                                                      flash_attention)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    scale = HEAD_DIM ** -0.5
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for s in (128, 256, 512, 1024):
            b = N // s
            q, k, v, do = (torch.randn(b, s, HEADS, HEAD_DIM, generator=gen,
                                       device="cuda").to(dt)
                           for _ in range(4))
            for t in (q, k, v):
                t.requires_grad_()
            ids = torch.ones(b, s, dtype=torch.int32, device="cuda")
            seg = SegmentIds(ids, ids)

            def flash():
                flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), seg, causal=True,
                                sm_scale=scale).backward(do.transpose(1, 2))

            def standard():
                _standard_attention(q, k, v, ids, scale).backward(do)

            key = f"{gemm_rate(dt)} seq{s}"
            out[key] = {"batch": b, "flash_ms": cuda_ms(flash),
                        "standard_ms": cuda_ms(standard)}
            log(f"crossover {key} bs {b}: attention fwd+bwd flash "
                f"{out[key]['flash_ms']:.3f} ms, standard "
                f"{out[key]['standard_ms']:.3f} ms")
            del q, k, v, do
    return out


def _saved_bytes(fn):
    """``fn()``'s output and the bytes of the tensors its backward keeps
    (``saved_tensors_hooks``), each tensor counted once."""
    saved = {}

    def pack(t):
        saved[id(t)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(saved.values())


def phase_sketch_kinds(draws=4):
    """``linear_grp`` at (8192, 768) -> 768, bias on, for each sketch kind
    (ratio 0.2: k = 1638), and ``linear_crs`` (384 sampled columns, the
    ``DenseCRS`` default), in f32 and bf16: the forward and dx against the
    exact ``linear`` (within TOL), dW's relative 2-norm error against the
    exact dW over ``draws`` draws, the bytes the backward keeps, and the
    forward + backward ms (CUDA events)."""
    from fewbit_tpu_torch.functional import linear, linear_crs, linear_grp
    from fewbit_tpu_torch.functional.linear import MATMUL_KINDS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = gemm_rate(dt)
        x, g = (torch.randn(N, HIDDEN, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        w = (torch.randn(HIDDEN, HIDDEN, generator=gen, device="cuda")
             * HIDDEN ** -0.5).to(dt)
        b = (torch.randn(HIDDEN, generator=gen, device="cuda") * 0.1).to(dt)

        def run(fn, seed):
            xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
            key = torch.Generator(device="cuda").manual_seed(seed)
            y, nbytes = _saved_bytes(lambda: fn(xx, ww, b, key))
            y.backward(g)
            return y.detach(), xx.grad, ww.grad.float(), nbytes

        y0, dx0, dw0, exact_bytes = run(lambda xx, ww, bb, _: linear(
            xx, ww, bb), 0)
        rows = {"exact": {"residual_bytes": exact_bytes, "ms": cuda_ms(
            lambda: run(lambda xx, ww, bb, _: linear(xx, ww, bb), 0))}}
        for kind in MATMUL_KINDS + ("crs",):
            if kind == "crs":
                def fn(xx, ww, bb, key):
                    return linear_crs(xx, ww, bb, key, HIDDEN // 2)
            else:
                def fn(xx, ww, bb, key, kind=kind):
                    return linear_grp(xx, ww, bb, key, proj_dim_ratio=0.2,
                                      matmul=kind)
            rel, errs = [], {}
            for i in range(draws):
                y, dx, dw, nbytes = run(fn, 100 + i)
                if i == 0:
                    errs = {
                        "forward": compare(f"{kind} {tag}: forward vs "
                                           f"linear", y, y0, TOL[dt]),
                        "dx": compare(f"{kind} {tag}: dx vs exact", dx, dx0,
                                      TOL[dt])}
                rel.append((torch.linalg.norm(dw - dw0)
                            / torch.linalg.norm(dw0)).item())
            row = {**errs, "dw_rel_err": rel, "residual_bytes": nbytes,
                   "ms": cuda_ms(lambda: run(fn, 200))}
            rows[kind] = row
            log(f"sketch {kind} {tag}: forward err {row['forward']:.3g}, dx "
                f"err {row['dx']:.3g} against the exact linear; dW relative "
                f"error over {draws} draws {[round(r, 4) for r in rel]}; "
                f"backward keeps {nbytes} B (exact linear "
                f"{exact_bytes} B); fwd+bwd {row['ms']:.3f} ms (exact "
                f"{rows['exact']['ms']:.3f})")
        out[tag] = rows
        del x, g, w, b, y0, dx0, dw0
        torch.cuda.empty_cache()
    return out


def _batches(path, seed):
    """Endless batches of a path on the card: MRPC-shaped for RoBERTa,
    ``synthetic_lm`` for GPT, normal x of (8192, 768) for the MLP."""
    from fewbit_tpu_torch.train import synthetic_glue, synthetic_lm

    if path == "mlp":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        while True:
            yield {"x": torch.randn(N, HIDDEN, generator=gen,
                                    device="cuda")}
    if path.startswith("gpt2_small"):
        source = synthetic_lm(GPT_BS, GPT_SEQ, seed=seed)
    else:
        source = synthetic_glue(BS, SEQ, seed=seed)
    for b in source:
        yield {k: torch.from_numpy(v).to("cuda").long()
               for k, v in b.items()}


def _model(path, dt, fewbit, flash=None, tp_group=None, train=None,
           **overrides):
    """A path's model in ``dt`` (vanilla or few-bit, random weights from
    SEED) and its training step (``TrainConfig(**train)``, by default
    100 steps at 1e-5).  On a flash path attention dropout is 0 and the
    few-bit model takes flash attention (unless ``flash`` says
    otherwise); vanilla takes the standard attention.  ``overrides`` are
    config fields; with ``tp_group`` the model is a tp slice on it."""
    from fewbit_tpu_torch.models import (MLP, GPTConfig, GPTForCausalLM,
                                         RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                        classification_loss, make_train_step)

    flash_path = bool(set(PATHS[path]) & set(FLASH))
    switches = dict(dtype=dt, gelu_bits=3 if fewbit else None,
                    proj_dim_ratio=0.2 if fewbit else None)
    if path not in ("roberta_default", "mlp"):
        # The reference's default sketch is gaussian: the paths of kernels
        # 1-3 ask for the countsketch.
        switches.update(sketch="countsketch",
                        flash_attention=(flash_path and fewbit
                                         if flash is None else flash))
    if flash_path:
        switches["attention_dropout"] = 0.0
    switches.update(overrides)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if path == "mlp":
        model = MLP(MLP_FEATURES, **switches, device="cuda", generator=gen,
                    in_features=HIDDEN)
        return model, _mlp_step(model)
    loss_fn = classification_loss
    if path == "roberta_default":
        # sketch and fused_ffn left at the reference's defaults.
        cfg = RobertaConfig(**switches)
    elif path.startswith("gpt2_small"):
        cfg = GPTConfig(**switches)
        loss_fn = causal_lm_loss
    else:
        cfg = RobertaConfig(**switches,
                            fused_ffn=path != "roberta_unfused_ffn")
    model_cls = (GPTForCausalLM if path.startswith("gpt2_small")
                 else RobertaForSequenceClassification)
    model = model_cls(cfg, device="cuda", generator=gen, tp_group=tp_group)
    step = make_train_step(model, TrainConfig(**(train or dict(
        total_steps=100, learning_rate=1e-5))), loss_fn=loss_fn)
    return model, step


def _mlp_step(model):
    """The MLP's training step, as the RoBERTa step's interface: SGD (lr
    1e-3, ``benchmark/bench_linear.py``) on the mean square output, the
    sketch generator seeded from ``generator``."""
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)

    def step(batch, generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        sketch_gen = torch.Generator(device="cuda").manual_seed(seed)
        loss = (model(batch["x"], sketch_gen) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return step


def _forward(path, model, batch, gen=None):
    """A model's output on a batch of its path, without gradients."""
    with torch.no_grad():
        if path == "mlp":
            return model(batch["x"], gen)
        return model(batch["input_ids"], batch["attention_mask"],
                     sketch_generator=gen)


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


def phase_forward_check(path, model):
    """The few-bit forward is exact: its logits equal those of a vanilla
    model holding the same weights (f32 sums in another order: tolerance
    1e-3).  Returns that vanilla model and its step."""
    vanilla, vstep = _model(path, torch.float32, fewbit=False)
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
    batch = next(_batches(path, SEED + 7))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    got = _forward(path, model, batch, gen)
    want = _forward(path, vanilla, batch)
    err = compare(f"{path}: few-bit forward vs vanilla logits", got, want,
                  1e-3)
    log(f"{path}: few-bit forward logits {tuple(got.shape)} vs vanilla: "
        f"max abs err {err}")
    return vanilla, vstep


def _checked_step(path, tag, step, batch, gen):
    """One few-bit step that launches exactly the path's kernels: (loss,
    seconds, peak bytes above those held before)."""
    from fewbit_tpu_torch.ops import kernels as K

    expected = {name: PATHS[path].get(name, 0) for name in K.KERNELS}
    before = K.launch_counts()
    loss, sec, peak = _timed_step(step, batch, gen)
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    if delta != expected:
        raise AssertionError(f"{path} {tag}: launches {delta}, expected "
                             f"{expected}")
    if not np.isfinite(loss):
        raise AssertionError(f"{path} {tag}: loss {loss}")
    log(f"{path} {tag}: loss {loss:.6f}, {sec * 1e3:.1f} ms, peak "
        f"{peak / 2**30:.3f} GiB above held, launches "
        f"{ {k: v for k, v in delta.items() if v} }")
    return loss, sec, peak


def _checked_steps(path, step, batches, gen, n, tag="few-bit f32"):
    """The path's main run: every count starts at 0 just before it and is
    read just after.  Returns ({losses, step_ms, peak_bytes}, counts)."""
    from fewbit_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    runs = [_checked_step(path, f"{tag} step {i}", step, next(batches), gen)
            for i in range(n)]
    return ({"losses": [r[0] for r in runs],
             "step_ms": [r[1] * 1e3 for r in runs],
             "peak_bytes": [r[2] for r in runs]}, K.launch_counts())


def _vanilla_vs_fewbit(path, steps, batches, gen, turns):
    """Vanilla and few-bit, same weights and batches, in turns (vanilla,
    few-bit, few-bit, vanilla, ...): step ms and peak bytes above held.
    The few-bit peak must be lower."""
    timed = {"vanilla": [], "fewbit": []}
    peaks = {"vanilla": [], "fewbit": []}
    for order in (("vanilla", "fewbit"), ("fewbit", "vanilla")) * turns:
        batch = next(batches)
        for name in order:
            loss, sec, peak = _timed_step(steps[name], batch, gen)
            if not np.isfinite(loss):
                raise AssertionError(f"{path} {name}: loss {loss}")
            timed[name].append(sec * 1e3)
            peaks[name].append(peak)
    v_ms, fb_ms = (statistics.median(timed[k]) for k in ("vanilla",
                                                         "fewbit"))
    v_peak, fb_peak = max(peaks["vanilla"]), max(peaks["fewbit"])
    log(f"{path} f32: step ms vanilla {timed['vanilla']} (median "
        f"{v_ms:.2f}), few-bit {timed['fewbit']} (median {fb_ms:.2f}); "
        f"peak above held: vanilla {v_peak} B ({v_peak / 2**30:.3f} GiB), "
        f"few-bit {fb_peak} B ({fb_peak / 2**30:.3f} GiB), saving "
        f"{100 * (1 - fb_peak / v_peak):.2f}%")
    if not fb_peak < v_peak:
        raise AssertionError(f"{path}: few-bit peak {fb_peak} >= vanilla "
                             f"{v_peak}")
    return {"vanilla_step_ms": timed["vanilla"],
            "fewbit_step_ms": timed["fewbit"],
            "vanilla_peak_bytes": v_peak, "fewbit_peak_bytes": fb_peak}


# Device kernels by a part of their name, for the profiled steps.
KERNEL_GROUPS = {
    "kernel_1": ("matmul_sketch_kernel", "input_sketch_kernel"),
    "kernel_2": ("dense_act_sketch",),
    "kernel_3": ("matmul_lut_bwd",),
    "kernel_6": ("dense_act_kernel", "dense_act_kloop", "dense_act_resident",
                 "dense_act_pipelined"),
    "kernel_5": ("act_backward_kernel",),
    "weight_prologue": ("prep_weight_kernel",),
    "column_partials": ("sum_partials_kernel",),
    "flash": ("flash_",),
    "flash_forward": ("flash_forward",),
    # Library calls (no kernel of the port's has these in its name): every
    # cuBLAS GEMM, among them the dense sketches' products, and torch's
    # random draws (the gaussian projections' blocks, dropout masks).
    "library_gemm": ("gemm",),
    "random_draws": ("distribution",),
}


def profiled_steps(path, step, batches, gen, n=2):
    """``n`` few-bit steps under the profiler (after the steps already
    taken): device milliseconds per step, busy in all and by kernel group,
    and the wall time of a profiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(next(batches), gen)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    out = {"wall_ms": wall, "busy_ms": 0.0,
           **{group: 0.0 for group in KERNEL_GROUPS}}
    for e in prof.key_averages():
        ms = e.device_time_total / 1e3 / n
        out["busy_ms"] += ms
        for group, parts in KERNEL_GROUPS.items():
            if any(part in e.key for part in parts):
                out[group] += ms
    if not out["busy_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    out["idle_share"] = 1 - out["busy_ms"] / wall
    log(f"{path}: profiled few-bit f32 step, device ms per step: "
        f"{json.dumps(out)}")
    return out


def phase_profile(path):
    """Only a path's few-bit steps: two to warm up, four timed without the
    profiler (their ms and their largest peak above held, in bytes), two
    under it."""
    batches = _batches(path, SEED)
    gen = torch.Generator().manual_seed(SEED)
    model, step = _model(path, torch.float32, fewbit=True)
    for _ in range(2):
        step(next(batches), gen)
    runs = [_timed_step(step, next(batches), gen) for _ in range(4)]
    timed = [sec * 1e3 for _, sec, _ in runs]
    log(f"{path}: few-bit f32 step ms, unprofiled: {timed} (median "
        f"{statistics.median(timed):.2f}); peak above held "
        f"{max(peak for *_, peak in runs)} B")
    return profiled_steps(path, step, batches, gen)


def phase_path(path):
    """A few-bit path's forward check, its checked f32 steps, vanilla
    against few-bit 4 steps each in turns, and one bf16 step."""
    batches = _batches(path, SEED)
    gen = torch.Generator().manual_seed(SEED)
    model, step = _model(path, torch.float32, fewbit=True)
    vmodel, vstep = phase_forward_check(path, model)
    runs, counts = _checked_steps(path, step, batches, gen, 3)
    # Each model has taken a step, so its optimizer state is in what is
    # held before the timed steps.
    vstep(next(_batches(path, SEED)), gen)
    out = {"f32_losses": runs["losses"],
           **_vanilla_vs_fewbit(path, {"vanilla": vstep, "fewbit": step},
                                batches, gen, turns=2)}
    if path in ("roberta_fused_ffn", "gpt2_small_flash", "roberta_default"):
        out["profile"] = profiled_steps(path, step, batches, gen)
    if path == "roberta_default":
        out["eval"] = _strict_eval(path, model)
    del model, step, vmodel, vstep
    torch.cuda.empty_cache()
    if path == "gpt2_small_flash":
        out["fewbit_standard_attention"] = _fewbit_standard(path, batches,
                                                            gen)
    bmodel, bstep = _model(path, torch.bfloat16, fewbit=True)
    out["bf16_loss"] = _checked_step(path, "few-bit bf16 step", bstep,
                                     next(_batches(path, SEED)), gen)[0]
    del bmodel, bstep
    torch.cuda.empty_cache()
    if path == "roberta_default":
        out["checkpoint"] = _checkpoint_round_trip(path)
    return out, counts


def _strict_eval(path, model):
    """The eval step on a held batch under FEWBIT_TPU_STRICT_SKETCH=1 (a
    sketched module without a generator would raise): finite accuracy and
    loss."""
    from fewbit_tpu_torch.train import make_eval_step

    os.environ["FEWBIT_TPU_STRICT_SKETCH"] = "1"
    metrics = make_eval_step(model)(next(_batches(path, SEED + 9)))
    del os.environ["FEWBIT_TPU_STRICT_SKETCH"]
    out = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"{path} eval: {out}")
    log(f"{path}: eval step on a held batch, strict sketch mode: {out}")
    return out


def _checkpoint_round_trip(path):
    """Four f32 steps, a checkpoint after the second; a fresh model and
    step restored from it take steps 3 and 4 on the same batches and
    generator.  Step 3's loss must equal the uninterrupted run's to the
    bit; step 4's (after the restored optimizer's update) is printed."""
    from fewbit_tpu_torch.train import restore_checkpoint, save_checkpoint

    batches = _batches(path, SEED + 11)
    batch = [next(batches) for _ in range(4)]
    gen = torch.Generator().manual_seed(SEED)
    model, step = _model(path, torch.float32, fewbit=True)
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.pt")
        for i in range(4):
            if i == 2:
                save_checkpoint(ckpt, model, step)
                state = gen.get_state()
            losses.append(step(batch[i], gen)["loss"].item())
        del model, step
        torch.cuda.empty_cache()
        model, step = _model(path, torch.float32, fewbit=True)
        count = restore_checkpoint(ckpt, model, step)
    gen = torch.Generator()
    gen.set_state(state)
    resumed = [step(b, gen)["loss"].item() for b in batch[2:]]
    del model, step
    torch.cuda.empty_cache()
    out = {"restored_step": count, "losses": losses, "resumed": resumed,
           "step3_equal": resumed[0] == losses[2],
           "step4_abs_diff": abs(resumed[1] - losses[3])}
    log(f"{path}: checkpoint after step {count}: uninterrupted losses "
        f"{losses}, resumed steps 3, 4: {resumed}; step 3 equal to the bit: "
        f"{out['step3_equal']}, step 4 differs by {out['step4_abs_diff']}")
    if count != 2 or not out["step3_equal"]:
        raise AssertionError(f"{path} checkpoint round trip: {out}")
    return out


def _fewbit_standard(path, batches, gen):
    """The few-bit model on the standard attention path (attention dropout
    0), for comparison with flash: ms and peak above held of its second
    step."""
    model, step = _model(path, torch.float32, fewbit=True, flash=False)
    step(next(batches), gen)
    loss, sec, peak = _timed_step(step, next(batches), gen)
    if not np.isfinite(loss):
        raise AssertionError(f"{path} few-bit standard attention: {loss}")
    log(f"{path}: few-bit on the standard attention path: {sec * 1e3:.2f} "
        f"ms, peak above held {peak} B ({peak / 2**30:.3f} GiB)")
    del model, step
    torch.cuda.empty_cache()
    return {"step_ms": sec * 1e3, "peak_bytes": peak}


def phase_steps(path):
    """A path's 2 checked f32 few-bit steps."""
    model, step = _model(path, torch.float32, fewbit=True)
    runs, counts = _checked_steps(path, step, _batches(path, SEED),
                                  torch.Generator().manual_seed(SEED), 2)
    del model, step
    torch.cuda.empty_cache()
    return {"f32_losses": runs["losses"]}, counts


def phase_exp_megakernel():
    """The megakernel experiment through its entry point, at its own shape:
    every schedule's count starts at 0 just before it, is read just after
    and must be EXP_LAUNCHES'.  Returns (rows, counts)."""
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.tools import exp_megakernel

    K.reset_launch_counts()
    rows = exp_megakernel.main(["--iters", str(EXP_ITERS), "--rounds",
                                str(EXP_ROUNDS)])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expected = {name: EXP_LAUNCHES.get(name, 0) for name in K.KERNELS}
    if counts != expected:
        raise AssertionError(f"exp_megakernel: launches {counts}, expected "
                             f"{expected}")
    by_row = {}
    for row in rows:
        if row["status"] == "ok" and row["kernel"] in K.KERNELS:
            if not (np.isfinite(row["ms"]) and row["ms"] > 0):
                raise AssertionError(f"exp_megakernel: {row}")
            by_row[row["kernel"]] = by_row.get(row["kernel"], 0) + row["calls"]
    if by_row != EXP_LAUNCHES:
        raise AssertionError(f"exp_megakernel: rows call {by_row}, expected "
                             f"{EXP_LAUNCHES}")
    refused = [r["name"] for r in rows if r["status"] != "ok"]
    if refused != ["direct f32", "emit f32"]:
        raise AssertionError(f"exp_megakernel: outside the envelope: "
                             f"{refused}")
    return rows, counts


# The projections that `_dense` sketches in path U's config-built model.
SURGERY_PATT = (r".*/(query|key|value|output|intermediate|ffn_output"
                r"|head_dense|head_out)$")
ATTENTION_PATT = r".*/attention/(query|key|value|output)$"
# Variance triples on the card (f32) against f64 on the CPU, relative.
VARIANCE_RTOL = 1e-5
# The timed turns' losses, U's against the converted model's, relative.
# The two differ only by the order of the embedding backward's sums, but
# training amplifies that: on an H100 (80GB HBM3, 700 W) the losses were
# equal to the bit for five steps, then 7.5e-7, 1.1e-5, 1.9e-5 and 4.6e-5
# apart.  A wrong conversion shows in the first step's bit comparison.
SURGERY_LOSS_RTOL = 1e-3


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` within;
    the caller's setting after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _launched(run):
    """``run()`` with every count set to 0 just before it; returns its
    result and the counts read just after."""
    from fewbit_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, K.launch_counts()


def _expect_u_counts(tag, counts):
    want = {k: PATHS["roberta_unfused_ffn"].get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"surgery {tag}: launches {counts}, expected "
                             f"{want}")
    return {k: v for k, v in counts.items() if v}


def _grads_step(model, batch, seed):
    """One forward and backward (dropout on), no update: logits, loss and
    every gradient by name; the gradients are then dropped."""
    from fewbit_tpu_torch.train import classification_loss

    dropout_gen = torch.Generator(device="cuda").manual_seed(seed)
    sketch_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    logits = model(batch["input_ids"], batch["attention_mask"],
                   deterministic=False, dropout_generator=dropout_gen,
                   sketch_generator=sketch_gen)
    loss = classification_loss(logits, batch["labels"])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach(), loss.detach(), grads


def _surgery_equal(u_out, c_out):
    """The converted model's logits, loss and gradients equal U's to the
    bit; returns the number of gradients compared."""
    (ul, uloss, ug), (cl, closs, cg) = u_out, c_out
    if not (torch.equal(ul, cl) and torch.equal(uloss, closs)):
        raise AssertionError(f"surgery: converted logits/loss differ from "
                             f"U's: loss {closs.item()} vs {uloss.item()}, "
                             f"logits max diff "
                             f"{(ul - cl).abs().max().item()}")
    if list(ug) != list(cg):
        raise AssertionError("surgery: parameter names differ from U's")
    differ = [n for n in ug if not torch.equal(ug[n], cg[n])]
    if differ:
        raise AssertionError(f"surgery: gradients differ from U's: {differ}")
    return len(ug)


def _accounting():
    """Residual bytes by ``estimate_memory_usage`` at the path's shapes,
    each beside the bytes its shapes imply: one RoBERTa-base FFN (exact
    Dense layers) with exact GELU and with 3-bit GELU through the patch
    (3/8 byte per element plus the 8-level LUT in place of z), and one
    attention projection as ``nn.Linear`` and under the countsketch patch
    (K_EFF sketch rows and the N signs in place of x)."""
    from torch import nn

    from fewbit_tpu_torch.modules.linear import Dense
    from fewbit_tpu_torch.patch import (use_fewbit_activation,
                                        use_fewbit_dense)
    from fewbit_tpu_torch.util import estimate_memory_usage

    f32 = 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn(BS, SEQ, HIDDEN, generator=gen, device="cuda")
    up = Dense(HIDDEN, FFN, torch.float32, device="cuda", generator=gen)
    down = Dense(FFN, HIDDEN, torch.float32, device="cuda", generator=gen)
    proj = nn.Linear(HIDDEN, HIDDEN, device="cuda")

    def ffn(t):
        return down(nn.functional.gelu(up(t), approximate="none"))

    weights = 2 * HIDDEN * FFN * f32
    # x for dW of the up projection, z for GELU, h for dW of the down one.
    exact_ffn = weights + N * HIDDEN * f32 + 2 * N * FFN * f32
    codes = 3 * -(-N // 32) * FFN * 4 + 8 * f32
    rows = {"ffn exact gelu": (estimate_memory_usage(ffn, x), exact_ffn)}
    with use_fewbit_activation("gelu", bits=3):
        rows["ffn 3-bit gelu"] = (estimate_memory_usage(ffn, x),
                                  exact_ffn - N * FFN * f32 + codes)
    w = HIDDEN * HIDDEN * f32
    rows["projection nn.Linear"] = (estimate_memory_usage(proj, x),
                                    w + N * HIDDEN * f32)
    with use_fewbit_dense(proj_dim_ratio=0.2, matmul="countsketch",
                          generator=torch.Generator(
                              device="cuda").manual_seed(SEED)):
        rows["projection countsketch 0.2"] = (
            estimate_memory_usage(proj, x),
            w + K_EFF * HIDDEN * f32 + N * f32)
    for name, (got, want) in rows.items():
        log(f"surgery accounting, {name} at ({BS}, {SEQ}, {HIDDEN}): "
            f"estimate_memory_usage {got} B, expected from the shapes "
            f"{want} B")
        if got != want:
            raise AssertionError(f"surgery accounting {name}: {got} B, "
                                 f"expected {want} B")
    return {name: {"bytes": got, "expected": want}
            for name, (got, want) in rows.items()}


def _variance(model, step, batch, gen):
    """The 48 attention projections wrapped in ``VarianceEstimator`` by
    ``map_module``, one training step (untimed: each state syncs the host
    once).  Hooks on each projection see its real input and the gradient
    of its output: the state's captures must equal them.  Then each
    layer's triple against the same functions on those tensors in f64 on
    the CPU.  The wrappers and hooks are taken off after."""
    from fewbit_tpu_torch.functional import (estimate_correlation,
                                             estimate_variance_rmm,
                                             estimate_variance_sgd)
    from fewbit_tpu_torch.modules import (VarianceEstimator,
                                          VarianceEstimatorState)
    from fewbit_tpu_torch.patch import use_fewbit_activation
    from fewbit_tpu_torch.util import map_module

    states, seen, hooks = {}, {}, []

    def see_input(path):
        def hook(mod, args):
            seen[path]["x"] = args[0].detach()
        return hook

    def see_grad(path):
        def hook(mod, args, out):
            out.register_hook(
                lambda g: seen[path].__setitem__("g", g.detach()))
        return hook

    def wrap(mod, path):
        states[path], seen[path] = VarianceEstimatorState(), {}
        hooks.append(mod.register_forward_pre_hook(see_input(path)))
        hooks.append(mod.register_forward_hook(see_grad(path)))
        return VarianceEstimator(mod, states[path])

    map_module(model, wrap, ATTENTION_PATT)
    if len(states) != 48:
        raise AssertionError(f"surgery variance: wrapped {len(states)} "
                             f"projections, expected 48")
    with use_fewbit_activation("gelu", bits=3):
        _, counts = _launched(lambda: step(batch, gen)["loss"].item())
    launches = _expect_u_counts("variance step", counts)
    for h in hooks:
        h.remove()
    worst, layers = 0.0, {}
    for path, st in states.items():
        if st.variance is None:
            raise AssertionError(f"surgery variance: {path} captured nothing")
        if not (torch.equal(st.input, seen[path]["x"])
                and torch.equal(st.grad_output, seen[path]["g"])):
            raise AssertionError(f"surgery variance {path}: the state did "
                                 f"not capture the layer's input and output "
                                 f"gradient")
        x = st.input.reshape(-1, HIDDEN).double().cpu()
        g = st.grad_output.reshape(-1, HIDDEN).double().cpu()
        want = (estimate_correlation(x, g).item(),
                estimate_variance_sgd(x, g, st.batch_size).item(),
                estimate_variance_rmm(x, g, st.proj_dim).item())
        rel = max(abs(a - b) / abs(b) for a, b in zip(st.variance, want))
        if not rel <= VARIANCE_RTOL:
            raise AssertionError(f"surgery variance {path}: {st.variance} "
                                 f"vs f64 {want}")
        worst = max(worst, rel)
        layers[path] = {"variance": st.variance, "f64": want,
                        "batch_size": st.batch_size, "proj_dim": st.proj_dim}
        st.input = st.grad_output = None
    seen.clear()
    map_module(model, lambda m, p: m.layer, ATTENTION_PATT)
    table = {}
    log(f"surgery variance, one step of the converted RoBERTa-base, mean "
        f"over 12 layers (k = {st.proj_dim} of {st.batch_size} rows):")
    log(f"{'layer':>8} {'corr':>8} {'var_sgd':>12} {'var_rmm':>12} "
        f"{'rmm/sgd':>8}")
    for kind in ("query", "key", "value", "output"):
        v = np.array([r["variance"] for p, r in layers.items()
                      if p.endswith("/" + kind)])
        corr, var_sgd, var_rmm = v.mean(0)
        ratio = float(np.mean(v[:, 2] / v[:, 1]))
        table[kind] = {"corr": corr, "var_sgd": var_sgd, "var_rmm": var_rmm,
                       "rmm_over_sgd": ratio}
        log(f"{kind:>8} {corr:>8.4f} {var_sgd:>12.4e} {var_rmm:>12.4e} "
            f"{ratio:>8.3f}")
    log(f"surgery variance: 48 captures equal to the hooks' input and "
        f"output gradient; triples within {worst:.3g} (relative) of f64 on "
        f"the CPU (limit {VARIANCE_RTOL}); launches {launches}")
    return {"table": table, "layers": layers, "max_rel_err_vs_f64": worst,
            "launches": launches}


def phase_surgery(turns=4):
    """The slice's own path: the vanilla RoBERTa-base (path U's shapes,
    f32) converted by ``map_module`` + ``convert_linear`` (countsketch at
    ratio 0.2 in every projection U sketches), its GELU through
    ``use_fewbit_activation``; path U's config-built model holds the same
    weights.  Both from one seed: logits, loss and every gradient equal to
    the bit, U's launches per step (kernels 1, 4, 5: 96, 12, 12), then
    a step each and ``turns`` x 2 timed steps each in turns (U, converted,
    converted, U, ...), the same launches, the losses within
    SURGERY_LOSS_RTOL; the accounting; the variance.

    Only the bit comparison runs under ``torch.use_deterministic_algorithms``:
    torch's CUDA embedding backward sums the 8192 rows of the one token type
    in an order that changes from run to run, which no bit comparison of
    two models could pass.  The timed steps run in the caller's mode, the
    one users train in."""
    from fewbit_tpu_torch.modules import RandomizedDense
    from fewbit_tpu_torch.patch import use_fewbit_activation
    from fewbit_tpu_torch.util import convert_linear, map_module

    path = "roberta_unfused_ffn"
    model, cstep = _model(path, torch.float32, fewbit=False)
    converted = []

    def convert(mod, p):
        converted.append(p)
        return convert_linear(mod, RandomizedDense, proj_dim_ratio=0.2,
                              matmul="countsketch")

    if map_module(model, convert, SURGERY_PATT) is not model:
        raise AssertionError("surgery: map_module replaced the root")
    if len(converted) != 12 * 6 + 2 or not all(
            isinstance(m, RandomizedDense) for p, m in model.named_modules()
            if p.rsplit(".", 1)[-1] in ("query", "key", "value", "output",
                                        "intermediate", "ffn_output",
                                        "head_dense", "head_out")):
        raise AssertionError(f"surgery: converted {converted}")
    umodel, ustep = _model(path, torch.float32, fewbit=True)
    umodel.load_state_dict(model.state_dict())

    def converted_run(fn):
        with use_fewbit_activation("gelu", bits=3):
            return fn()

    batches = _batches(path, SEED + 17)
    batch = next(batches)
    with _deterministic():
        u_out, u_counts = _launched(lambda: _grads_step(umodel, batch, SEED))
        c_out, c_counts = _launched(lambda: converted_run(
            lambda: _grads_step(model, batch, SEED)))
    n_grads = _surgery_equal(u_out, c_out)
    launches = {"u_step": _expect_u_counts("U step", u_counts),
                "converted_step": _expect_u_counts("converted step",
                                                   c_counts)}
    log(f"surgery: converted {len(converted)} projections; loss "
        f"{c_out[1].item():.6f}, logits and {n_grads} gradients equal to "
        f"U's to the bit; launches per step {launches['converted_step']} "
        f"(U {launches['u_step']})")
    del u_out, c_out
    steps = {"u": ustep, "converted": cstep}
    gens = {k: torch.Generator().manual_seed(SEED) for k in steps}
    timed = {k: [] for k in steps}
    peaks = {k: [] for k in steps}
    losses = {k: [] for k in steps}
    # One untimed step each (the optimizer's state), then the timed turns.
    for i, order in enumerate((("u", "converted"),)
                              + (("u", "converted"),
                                 ("converted", "u")) * turns):
        batch = next(batches)
        for name in order:
            def run():
                return _timed_step(steps[name], batch, gens[name])
            (loss, sec, peak), counts = _launched(
                (lambda: converted_run(run)) if name == "converted" else run)
            _expect_u_counts(f"{name} step {i}", counts)
            losses[name].append(loss)
            if i:
                timed[name].append(sec * 1e3)
                peaks[name].append(peak)
    u_loss, c_loss = np.array(losses["u"]), np.array(losses["converted"])
    loss_rel = float(np.max(np.abs(c_loss - u_loss) / np.abs(u_loss)))
    if not (np.all(np.isfinite(c_loss)) and loss_rel <= SURGERY_LOSS_RTOL):
        raise AssertionError(f"surgery: training losses differ: {losses}")
    log(f"surgery f32 steps in turns, ms: U {timed['u']} (median "
        f"{statistics.median(timed['u']):.2f}), converted "
        f"{timed['converted']} (median "
        f"{statistics.median(timed['converted']):.2f}); peak above held, B: "
        f"U {peaks['u']}, converted {peaks['converted']}; losses over "
        f"{len(u_loss)} steps within {loss_rel:.3g} (relative, limit "
        f"{SURGERY_LOSS_RTOL}): U {losses['u']}, converted "
        f"{losses['converted']}")
    out = {"converted": len(converted), "gradients_equal": n_grads,
           "launches": launches, "step_ms": timed, "peak_bytes": peaks,
           "losses": losses, "loss_max_rel_diff": loss_rel}
    del umodel, ustep, steps
    torch.cuda.empty_cache()
    out["accounting"] = _accounting()
    out["variance"] = _variance(model, cstep, next(batches),
                                gens["converted"])
    del model, cstep
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# The parallel phase (``python3 chip_smoke.py --parallel`` runs it alone).
# ---------------------------------------------------------------------------

# The two tp paths: path R and path G, without dropout; and the two on
# the flash op (F1-F3 on each rank's 6 local heads), held to the same
# bounds without the planted faults.
TP_PATHS = ("roberta_fused_ffn", "gpt2_small")
TP_FLASH_PATHS = ("roberta_flash", "gpt2_small_flash")
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
# Each rank process's time limit, seconds.
RANK_TIMEOUT = 900
# The tp runs' training: no warmup, so that steps 1 and 2 move the
# weights (every schedule's step 0 has learning rate 0).
TP_TRAIN = dict(total_steps=100, learning_rate=1e-5, warmup_ratio=0.0)
# Losses of the tp ranks' three steps against the single process's,
# relative: the two differ by the order of f32 sums.
PARALLEL_LOSS_RTOL = 1e-4
# Gradients of a parallel run against the single process's, relative, in
# the 2-norm (as tests/test_torch_models.py's _close_by_norm): GRAD_RTOL
# for dp.  A gradient that is zero up to rounding is held to GRAD_FLOOR.
# At tp the ranks sum their partial products in another order than one
# GEMM, so codes within rounding of a border flip (see _flip_noise), and
# each flip moves the gradients of its row in every layer below.  So the
# gathered tp gradients are held to TP_GRAD_RTOL, and the updates of the
# three steps (gathered, after minus before) to TP_UPDATE_RTOL of the
# single device's: constants set between what the sound runs read and
# what the planted faults of TP_FAULTS read on the card (PERF.md, PR 14).
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
TP_GRAD_RTOL, TP_UPDATE_RTOL = 2e-2, 5e-2
# Faults planted in one rank run each; the phase fails unless its checks
# see every one: their readings go into the summary.
TP_FAULTS = ("copy_to_tp without its all-reduce",
             "sketch generator folded by the tp rank",
             "row-parallel bias added before the all-reduce",
             "row-parallel biases left out of the optimizer")
# R at tp=2 with max_grad_norm far below the gradients' norm, so that
# every step clips: its clipped gradients (TP_GRAD_RTOL) and three steps'
# updates (TP_UPDATE_RTOL) against the single device's; and the fault
# planted in that row, which one of those two checks must see.
TP_CLIP_NORM = 1e-2
TP_CLIP_FAULT = "each rank clips by its own local norm"


def _loss_fn(path):
    from fewbit_tpu_torch.train import causal_lm_loss, classification_loss

    return causal_lm_loss if path.startswith("gpt") else classification_loss


def _ffn_modules(path, model):
    """Each layer's module that makes the few-bit codes: R's fused FFN,
    G's ``intermediate``."""
    if path.startswith("gpt"):
        return [layer.intermediate for layer in model.transformer.layers]
    return [layer.ffn for layer in model.roberta.layers]


def _grads_of(path, model, batch, keep_inputs=False, sketch=None):
    """One forward and backward without dropout under a fixed sketch
    generator (``sketch``, by default one seeded SEED + 1): logits (of a
    GPT sequence every 64th position), loss and every gradient by name,
    on the CPU; the launches it made; the packed codes each layer kept
    (the int32 residuals of shape (bits, words, M), in layer order; the
    flash op's int32 segment ids are not codes) and, with ``keep_inputs``,
    each layer's FFN input."""
    from fewbit_tpu_torch.ops import kernels as K

    inputs, codes = [], []

    def keep(mod, args):
        inputs.append(args[0].detach().reshape(-1, HIDDEN).cpu())

    def pack(t):
        if t.dtype == torch.int32 and t.dim() == 3:
            codes.append(t.detach().cpu())
        return t

    hooks = ([m.register_forward_pre_hook(keep)
              for m in _ffn_modules(path, model)] if keep_inputs else [])
    K.reset_launch_counts()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = model(batch["input_ids"], batch["attention_mask"],
                       sketch_generator=sketch or torch.Generator(
                           device="cuda").manual_seed(SEED + 1))
    loss = _loss_fn(path)(logits, batch["labels"])
    loss.backward()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for hook in hooks:
        hook.remove()
    if logits.ndim == 3:
        logits = logits[:, ::64]
    out = {"logits": logits.detach().cpu(), "loss": loss.item(),
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "counts": counts, "codes": codes, "inputs": inputs}
    model.zero_grad(set_to_none=True)
    return out


def _tp_residuals(model):
    """Residual bytes of one tp=2 rank's layer-0 projections of R at bs 64
    x seq 128 (``estimate_memory_usage``), each beside the bytes its
    local shapes imply: the fused FFN keeps 3-bit codes and the y sketch
    of its 1536 features, both weights (halves), x's sketch and the two
    sign vectors (whole), and the 8 LUT levels; query (768 -> 384) keeps
    x's sketch (whole) and its weight (half); output (384 -> 768) keeps
    the sketch of its 384-wide input and its weight (halves)."""
    from fewbit_tpu_torch.util import estimate_memory_usage

    f32 = 4
    layer = model.roberta.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn(BS, SEQ, HIDDEN, generator=gen, device="cuda")
    ctx = torch.randn(BS, SEQ, TP_WIDTH, generator=gen, device="cuda")
    signs = N * f32
    rows = {
        "ffn": (estimate_memory_usage(lambda t: layer.ffn(t, gen), x),
                3 * (N // 32) * TP_INNER * 4 + K_EFF * HIDDEN * f32
                + K_EFF * TP_INNER * f32 + 2 * HIDDEN * TP_INNER * f32
                + 2 * signs + 8 * f32),
        "query": (estimate_memory_usage(
            lambda t: layer.attention.query(t, gen), x),
            K_EFF * HIDDEN * f32 + TP_WIDTH * HIDDEN * f32 + signs),
        "output": (estimate_memory_usage(
            lambda t: layer.attention.output(t, gen), ctx),
            K_EFF * TP_WIDTH * f32 + HIDDEN * TP_WIDTH * f32 + signs)}
    for name, (got, want) in rows.items():
        log(f"parallel: residual bytes of one tp=2 rank's layer-0 {name} "
            f"at ({BS}, {SEQ}): estimate_memory_usage {got} B, from the "
            f"local shapes {want} B")
        if got != want:
            raise AssertionError(f"parallel residuals {name}: {got} B, "
                                 f"expected {want} B")
    return {name: {"bytes": got, "expected": want}
            for name, (got, want) in rows.items()}


def _random_biases(model):
    """Every bias of ``model`` (the LayerNorms' too) drawn as 0.1 z from
    SEED + 17, so that a bias placed or summed wrongly under tp shows in
    the logits; returns ``model``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
    return model


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _updates(model, before, keep=None):
    """Each parameter's change since ``before``, on the CPU (the names
    ``keep`` accepts, by default all)."""
    return {n: (p.detach() - before[n]).cpu()
            for n, p in model.named_parameters() if keep is None or keep(n)}


def _end_layers(names):
    """Whether a parameter name (of a model whose names are ``names``) is
    of its first or its last layer: the leaves a planted fault's run
    brings back."""
    last = max(int(n.split(".layers.")[1].split(".")[0]) for n in names
               if ".layers." in n)
    return lambda n: ".layers.0." in n or f".layers.{last}." in n


@contextlib.contextmanager
def _planted(fault, model, step):
    """``fault`` of TP_FAULTS planted in the port (or in ``step``'s
    optimizer) while the block runs."""
    from fewbit_tpu_torch.models import gpt, roberta
    from fewbit_tpu_torch.parallel import tp

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, vars(owner)[name]))
        setattr(owner, name, value)

    if fault == "copy_to_tp without its all-reduce":
        patch(tp._CopyToTP, "backward", staticmethod(lambda ctx, g: (g,
                                                                    None)))
    elif fault == "row-parallel bias added before the all-reduce":
        def early(out, tp_group, bias):
            return tp.reduce_from_tp(out + bias.to(out.dtype), tp_group)

        patch(roberta, "_row_parallel", early)
        patch(gpt, "_row_parallel", early)
    elif fault == TP_CLIP_FAULT:
        from fewbit_tpu_torch.train import loop

        local = loop.clip_by_global_norm_
        patch(loop, "clip_by_global_norm_",
              lambda params, max_norm, tp_group=None, split=None: local(
                  params, max_norm))
    elif fault == "row-parallel biases left out of the optimizer":
        late = {id(p) for n, p in model.named_parameters()
                if n.endswith(("output_bias", "ffn_bias"))}
        group = step.optimizer.param_groups[0]
        group["params"] = [p for p in group["params"] if id(p) not in late]
    try:
        yield
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)


def _tp_faults(path, mesh, state, tp):
    """Each fault of TP_FAULTS planted in a fresh f32 slice of ``state``:
    its logits, loss and the first and last layers' gradients (one
    forward and backward, the sketch generator folded by the tp rank
    for that fault), or for the optimizer's fault those layers' updates
    over the three steps."""
    from fewbit_tpu_torch.parallel import fold_shard_generator

    keep = _end_layers(state)
    out = {}
    for fault in TP_FAULTS:
        model, step = _model(path, torch.float32, True,
                             tp_group=mesh.tp_group, train=TP_TRAIN, **tp)
        model.load_state_dict(state)
        with _planted(fault, model, step):
            if fault.endswith("optimizer"):
                before = _params(model)
                _checked_steps(path, step, _batches(path, SEED + 3),
                               torch.Generator().manual_seed(SEED), 3,
                               f"parallel tp=2 rank {mesh.tp_rank} {fault}")
                out[fault] = {"updates": _updates(model, before, keep)}
            else:
                sketch = torch.Generator(device="cuda").manual_seed(SEED + 1)
                if fault.startswith("sketch"):
                    sketch = fold_shard_generator(sketch, mesh.tp_rank)
                run = _grads_of(path, model, next(_batches(path, SEED)),
                                sketch=sketch)
                out[fault] = {"logits": run["logits"], "loss": run["loss"],
                              "grads": {n: g for n, g in run["grads"].items()
                                        if keep(n)}}
        del model, step
        torch.cuda.empty_cache()
    return out


def _tp_rank(path, mesh, faults=True):
    """One rank of a tp=2 path: its slice of the single-device model (from
    SEED, its biases random, sharded by ``shard_tp_params``), one forward
    and backward, three f32 steps (the parameters' updates kept), one bf16
    step, and (with ``faults``) the planted faults' runs."""
    tag = f"parallel {path} tp=2 rank {mesh.tp_rank}"
    state = _tp_state(path, mesh)
    tp = dict(NO_DROPOUT, tp_size=TP, tp_axis="tp")
    model, step = _model(path, torch.float32, True, tp_group=mesh.tp_group,
                         train=TP_TRAIN, **tp)
    model.load_state_dict(state)
    out = _grads_of(path, model, next(_batches(path, SEED)))
    del out["inputs"]
    log(f"{tag}: one forward and backward, loss {out['loss']:.6f}, "
        f"launches { {k: v for k, v in out['counts'].items() if v} }")
    if path == "roberta_fused_ffn" and mesh.tp_rank == 0:
        out["residuals"] = _tp_residuals(model)
    before = _params(model)
    out["steps"], out["step_counts"] = _checked_steps(
        path, step, _batches(path, SEED + 3),
        torch.Generator().manual_seed(SEED), 3,
        f"parallel tp=2 rank {mesh.tp_rank} f32")
    out["updates"] = _updates(model, before)
    del model, step, before
    torch.cuda.empty_cache()
    model, step = _model(path, torch.bfloat16, True, tp_group=mesh.tp_group,
                         train=TP_TRAIN, **tp)
    model.load_state_dict(state)
    out["bf16"], _ = _checked_steps(path, step, _batches(path, SEED + 3),
                                    torch.Generator().manual_seed(SEED), 1,
                                    f"parallel tp=2 rank {mesh.tp_rank} bf16")
    del model, step
    torch.cuda.empty_cache()
    if faults:
        out["faults"] = _tp_faults(path, mesh, state, tp)
    return out


def _tp_state(path, mesh):
    """This rank's slice of the single-device f32 model of ``path``
    without dropout, its biases random."""
    from fewbit_tpu_torch.parallel import shard_tp_params

    single, _ = _model(path, torch.float32, True, **NO_DROPOUT)
    state = shard_tp_params(_random_biases(single).state_dict(),
                            mesh.tp_rank, TP)
    del single
    torch.cuda.empty_cache()
    return state


def _clip_run(path, model, step, tag, keep=None):
    """A run under ``max_grad_norm``: one forward and backward on the
    path's first batch and the step's clip (the norm, and the clipped
    gradients ``keep`` accepts); then three checked f32 steps (the norm
    each one's clip saw, the updates ``keep`` accepts)."""
    step.loss_and_grads(next(_batches(path, SEED)),
                        torch.Generator().manual_seed(SEED + 23))
    out = {"norm": step.clip_grads().item(),
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                     if keep is None or keep(n)}}
    model.zero_grad(set_to_none=True)
    before, norms = _params(model), []

    def recorded(batch, gen):
        res = step(batch, gen)
        norms.append(res["grad_norm"])
        return res

    out["steps"], out["step_counts"] = _checked_steps(
        path, recorded, _batches(path, SEED + 3),
        torch.Generator().manual_seed(SEED), 3, tag)
    out["norms"] = [n.item() for n in norms]
    out["updates"] = _updates(model, before, keep)
    return out


def _tp_clip_rank(mesh):
    """One rank of R at tp=2 under ``max_grad_norm = TP_CLIP_NORM``: the
    sound run and, on a fresh slice, the run with TP_CLIP_FAULT planted
    (its first and last layers only)."""
    path = "roberta_fused_ffn"
    state = _tp_state(path, mesh)
    out = {}
    for fault in (None, TP_CLIP_FAULT):
        model, step = _model(path, torch.float32, True,
                             tp_group=mesh.tp_group,
                             train=dict(TP_TRAIN, max_grad_norm=TP_CLIP_NORM),
                             **NO_DROPOUT, tp_size=TP, tp_axis="tp")
        model.load_state_dict(state)
        tag = (f"parallel tp=2 rank {mesh.tp_rank} clip f32"
               + (f", {fault}" if fault else ""))
        with _planted(fault, model, step):
            out[fault or "sound"] = _clip_run(
                path, model, step, tag,
                _end_layers(state) if fault else None)
        del model, step
        torch.cuda.empty_cache()
    return out


def _lm_unequal_batch():
    """A GPT batch whose second half (dp rank 1's) keeps 64 valid labels
    a row: the ranks hold unequal valid tokens."""
    batch = next(_batches("gpt2_small", SEED + 5))
    batch["labels"][GPT_BS // 2:, 64:] = -100
    return batch


def _dp_rank(mesh):
    """One rank of dp=2: R at global bs 64 (dropout on), the gradient after
    ``DistributedDataParallel``'s average; GPT without dropout on a batch
    whose ranks hold unequal valid tokens, the reported loss."""
    from fewbit_tpu_torch.ops import kernels as K
    from fewbit_tpu_torch.parallel import data_parallel_step, shard_batch
    from fewbit_tpu_torch.train import TrainConfig, make_train_step

    out = {}
    for path, batch, overrides in (
            ("roberta_fused_ffn", next(_batches("roberta_fused_ffn", SEED)),
             {}),
            ("gpt2_small", _lm_unequal_batch(), NO_DROPOUT)):
        model, _ = _model(path, torch.float32, True, **overrides)
        step = make_train_step(data_parallel_step(model, mesh),
                               TrainConfig(total_steps=100,
                                           learning_rate=1e-5),
                               loss_fn=_loss_fn(path), dp_group=mesh.dp_group)
        K.reset_launch_counts()
        loss = step.loss_and_grads(shard_batch(batch, mesh),
                                   torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        out[path] = {"loss": loss.item(), "counts": counts}
        if path == "roberta_fused_ffn":
            out[path]["grads"] = {n: p.grad.cpu()
                                  for n, p in model.named_parameters()}
        log(f"parallel dp=2 rank {mesh.dp_rank} {path}: loss "
            f"{out[path]['loss']:.6f}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        del model, step
        torch.cuda.empty_cache()
    return out


def rank_main(rank, workdir):
    """A rank process of the parallel phase: gloo with CUDA tensors on the
    one card, the tp=2 runs of R and G, then the dp=2 runs; what it saw
    goes to ``workdir/rank<rank>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fewbit_tpu_torch.parallel import (init_distributed,
                                           make_dp_tp_mesh, make_mesh)

    init_distributed(num_processes=TP, process_id=rank, backend="gloo",
                     init_method=f"file://{workdir}/store")
    tp_mesh, dp_mesh = make_dp_tp_mesh(1, TP), make_mesh(TP)
    out = {path: _tp_rank(path, tp_mesh) for path in TP_PATHS}
    for path in TP_FLASH_PATHS:
        out[path] = _tp_rank(path, tp_mesh, faults=False)
    out["clip"] = _tp_clip_rank(tp_mesh)
    out["dp"] = _dp_rank(dp_mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _nccl_world_of_one():
    """NCCL at world size 1, dp=1 x tp=1, path R: one step through
    ``data_parallel_step`` equals the plain step on the rank's folded
    generator to the bit (loss and every gradient, in deterministic
    mode), both launching R's kernels."""
    import torch.distributed as dist

    from fewbit_tpu_torch.parallel import (data_parallel_step,
                                           fold_shard_generator,
                                           init_distributed, make_mesh)
    from fewbit_tpu_torch.train import TrainConfig, make_train_step

    path = "roberta_fused_ffn"
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(num_processes=1, process_id=0, backend="nccl",
                         init_method=f"file://{tmp}/store")
        try:
            mesh = make_mesh(1)
            model, _ = _model(path, torch.float32, True)
            plain, plain_step = _model(path, torch.float32, True)
            step = make_train_step(data_parallel_step(model, mesh),
                                   TrainConfig(total_steps=100,
                                               learning_rate=1e-5),
                                   dp_group=mesh.dp_group)
            batch = next(_batches(path, SEED))
            with _deterministic():
                dp_loss, dp_counts = _launched(lambda: step.loss_and_grads(
                    batch, torch.Generator().manual_seed(SEED)))
                loss, counts = _launched(lambda: plain_step.loss_and_grads(
                    batch, fold_shard_generator(
                        torch.Generator().manual_seed(SEED), 0)))
        finally:
            dist.destroy_process_group()
    want = {k: PATHS[path].get(k, 0) for k in counts}
    differ = [n for (n, p), q in zip(model.named_parameters(),
                                     plain.parameters())
              if not torch.equal(p.grad, q.grad)]
    if (not torch.equal(dp_loss, loss) or differ or counts != want
            or dp_counts != want):
        raise AssertionError(f"parallel NCCL world 1: loss {dp_loss.item()} "
                             f"vs {loss.item()}, gradients differ: {differ}, "
                             f"launches {dp_counts} / {counts}")
    n = len(list(model.parameters()))
    log(f"parallel: NCCL, world size 1, dp=1 x tp=1, {path}: the "
        f"data_parallel_step step equals the plain step to the bit (loss "
        f"{loss.item():.6f}, {n} gradients), launches "
        f"{ {k: v for k, v in counts.items() if v} } each")
    del model, plain, plain_step, step
    torch.cuda.empty_cache()
    return {"loss": loss.item(), "gradients_equal": n}


def _spawn_ranks(workdir):
    """The two rank processes on the one card, each with its own time
    limit; either failing or hanging fails the phase.  Their output is
    printed after they end."""
    procs, logs = [], []
    try:
        for rank in range(TP):
            logs.append(open(os.path.join(workdir, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(rank), workdir], stdout=logs[-1],
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        t0 = time.perf_counter()
        codes = []
        for proc in procs:
            left = RANK_TIMEOUT - (time.perf_counter() - t0)
            try:
                codes.append(proc.wait(timeout=max(left, 1)))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for rank, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[rank {rank}] {line}")
            f.close()
    if codes != [0] * TP:
        raise AssertionError(f"parallel: rank exit codes {codes}")
    return time.perf_counter() - t0


def _rel_errors(got, want):
    """(relative 2-norm error, name) of each leaf of ``want`` whose norm
    reaches GRAD_FLOOR, largest first."""
    rows = []
    for name, b in want.items():
        a, b = got[name].cuda().float(), b.cuda().float()
        ref = b.norm().item()
        if ref >= GRAD_FLOOR:
            rows.append(((a - b).norm().item() / ref, name))
    return sorted(rows, reverse=True)


def _grads_close(tag, got, want, bound=GRAD_RTOL):
    """Each gradient (or update) of ``got`` against ``want`` (by name),
    in the 2-norm: within ``bound`` of ``want``'s norm; one whose norm is
    below GRAD_FLOOR (zero up to rounding: the key biases under the
    softmax) within GRAD_FLOOR.  Logs the largest errors; returns them."""
    if set(got) != set(want):
        raise AssertionError(f"{tag}: names {set(got) ^ set(want)}")
    bad = [n for n, b in want.items() if b.norm().item() < GRAD_FLOOR
           and (got[n].cuda() - b.cuda()).norm().item() > GRAD_FLOOR]
    rows = _rel_errors(got, want)
    bad += [n for err, n in rows if not err <= bound]
    out = {"max_rel_err": rows[0][0], "median_rel_err":
           statistics.median(r[0] for r in rows), "bound": bound,
           "worst": rows[0][1]}
    log(f"{tag}: {len(want)} leaves, relative 2-norm error largest "
        f"{out['max_rel_err']:.3g} ({out['worst']}), median "
        f"{out['median_rel_err']:.3g}, bound {bound:.3g}")
    if bad:
        raise AssertionError(f"{tag}: outside the bound: {bad}")
    return out


def _code_flips(a, b):
    """Codes that differ between two lists of packed code tensors."""
    from fewbit_tpu_torch.ops.bitpack import unpack_codes

    return sum(int((unpack_codes(x.cuda(), 3, N) != unpack_codes(
        y.cuda(), 3, N)).sum()) for x, y in zip(a, b))


def _flip_noise(path, model, want):
    """The single device against itself when its first LayerNorm's scale
    moves by 2^-22 of itself, feature by feature with random signs (a
    rounding-size change of every row): the codes it flips, and the
    largest relative gradient error over the gradients above GRAD_FLOOR.
    Read beside the tp run's flips and errors: what rounding alone does."""
    from fewbit_tpu_torch.models.roberta import LayerNorm

    norm = next(m for m in model.modules() if isinstance(m, LayerNorm))
    kept = norm.weight.detach().clone()
    sign = torch.randint(0, 2, kept.shape, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             SEED)) * 2 - 1
    with torch.no_grad():
        norm.weight.mul_(1 + sign * 2.0 ** -22)
    moved = _grads_of(path, model, next(_batches(path, SEED)))
    with torch.no_grad():
        norm.weight.copy_(kept)
    errs = [err for err, _ in _rel_errors(moved["grads"], want["grads"])]
    flips = _code_flips(moved["codes"], want["codes"])
    log(f"parallel {path}: the single device against itself with its first "
        f"LayerNorm's scale moved by 2^-22: {flips} codes flip, gradients' "
        f"relative 2-norm error largest {max(errs):.3g}, median "
        f"{statistics.median(errs):.3g}")
    return max(errs), flips


@torch.no_grad()
def _flips_at_tp(path, model, ranks, want):
    """Each layer's codes at tp=2 (the two ranks' halves side by side)
    against the single device's: a code may differ only where the single
    device's pre-activation lies within FLIP_BAND of a border, on at most
    FLIP_FRACTION of the elements.  Returns the flips per layer."""
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.ops import kernels as K

    spec, borders, _ = resolve_activation("gelu", bits=3, device="cuda")
    mods = _ffn_modules(path, model)
    if not len(want["codes"]) == len(mods) == len(ranks[0]["codes"]):
        raise AssertionError(f"parallel {path}: codes of "
                             f"{len(want['codes'])} / "
                             f"{len(ranks[0]['codes'])} layers kept")
    flips = []
    for i, mod in enumerate(mods):
        w, b = ((mod.weight, mod.bias) if path.startswith("gpt") else
                (mod.up_weight, mod.up_bias))
        z0 = K.dot_f32(want["inputs"][i].cuda(), w.t()) + b.float()
        tp = torch.cat([r["codes"][i] for r in ranks], dim=-1).cuda()
        flips.append(code_flips(f"parallel {path} tp=2 layer {i} codes", tp,
                                want["codes"][i].cuda(), z0, borders,
                                spec.bits))
    return flips


def _fault_readings(path, ranks, want, updates):
    """What the phase's checks read on each planted fault's run: the
    logits' and the loss's error (relative to the single device's largest
    logit and loss), the largest relative 2-norm error of the first and
    last layers' gathered gradients, or of their updates; and whether a
    check sees it (a reading past TOL, TP_GRAD_RTOL or TP_UPDATE_RTOL)."""
    from fewbit_tpu_torch.parallel import gather_tp_params

    out = {}
    for fault in TP_FAULTS:
        runs = [r["faults"][fault] for r in ranks]
        if "updates" in runs[0]:
            got = gather_tp_params([r["updates"] for r in runs])
            err = _rel_errors(got, {n: updates[n] for n in got})[0]
            reading = {"updates_max_rel_err": err[0], "worst": err[1],
                       "seen": err[0] > TP_UPDATE_RTOL}
        else:
            scale = max(1.0, want["logits"].abs().max().item())
            logits = max((r["logits"] - want["logits"]).abs().max().item()
                         / scale for r in runs)
            loss = max(abs(r["loss"] - want["loss"]) / abs(want["loss"])
                       for r in runs)
            got = gather_tp_params([r["grads"] for r in runs])
            err = _rel_errors(got, {n: want["grads"][n] for n in got})[0]
            reading = {"logits_rel_err": logits, "loss_rel_err": loss,
                       "grads_max_rel_err": err[0], "worst": err[1],
                       "seen": (logits > TOL[torch.float32]
                                or loss > TOL[torch.float32]
                                or err[0] > TP_GRAD_RTOL)}
        log(f"parallel {path} tp=2, planted fault '{fault}': {reading}")
        out[fault] = reading
    return out


def _tp_reference(path, ranks):
    """The single-device path (same weights, biases random, batches,
    generators) against the two ranks: logits, loss, gathered gradients,
    codes, the three steps' losses and updates, and what the checks read
    on the planted faults."""
    from fewbit_tpu_torch.parallel import gather_tp_params

    tag = f"parallel {path} tp=2"
    model, step = _model(path, torch.float32, True, train=TP_TRAIN,
                         **NO_DROPOUT)
    _random_biases(model)
    want = _grads_of(path, model, next(_batches(path, SEED)),
                     keep_inputs=True)
    noise, noise_flips = _flip_noise(path, model, want)
    out = {"loss": want["loss"], "flip_noise": noise,
           "flip_noise_codes": noise_flips,
           "rank_losses": [r["loss"] for r in ranks]}
    for r in ranks:
        compare(f"{tag} logits", r["logits"], want["logits"],
                TOL[torch.float32])
        if abs(r["loss"] - want["loss"]) > TOL[torch.float32] * abs(
                want["loss"]):
            raise AssertionError(f"{tag}: loss {r['loss']} vs {want['loss']}")
        if r["counts"] != want["counts"]:
            raise AssertionError(f"{tag}: launches {r['counts']} vs "
                                 f"{want['counts']}")
    out["code_flips"] = _flips_at_tp(path, model, ranks, want)
    log(f"{tag}: codes flipped against the single device, by layer "
        f"{out['code_flips']} ({sum(out['code_flips'])} in all), each "
        f"within FLIP_BAND of a border; the single device against itself: "
        f"{noise_flips}")
    before = _params(model)
    steps, _ = _checked_steps(path, step, _batches(path, SEED + 3),
                              torch.Generator().manual_seed(SEED), 3,
                              "parallel single-device f32")
    updates = _updates(model, before)
    del before
    faults = "faults" in ranks[0]
    out["faults"] = (_fault_readings(path, ranks, want, updates) if faults
                     else {})
    out["gradients"] = _grads_close(
        f"{tag} gathered gradients",
        gather_tp_params([r["grads"] for r in ranks]), want["grads"],
        TP_GRAD_RTOL)
    out["updates"] = _grads_close(
        f"{tag} gathered updates of the three steps",
        gather_tp_params([r["updates"] for r in ranks]), updates,
        TP_UPDATE_RTOL)
    for r in ranks:
        rel = [abs(a - b) / abs(b) for a, b in zip(r["steps"]["losses"],
                                                    steps["losses"])]
        if not max(rel) <= PARALLEL_LOSS_RTOL:
            raise AssertionError(f"{tag}: step losses {r['steps']} vs "
                                 f"{steps['losses']}")
        if not np.isfinite(r["bf16"]["losses"][0]):
            raise AssertionError(f"{tag}: bf16 loss {r['bf16']}")
    unseen = [f for f, reading in out["faults"].items()
              if not reading["seen"]]
    if unseen:
        raise AssertionError(f"{tag}: the checks pass the planted faults "
                             f"{unseen}")
    out.update(single_steps=steps, rank_steps=[r["steps"] for r in ranks],
               bf16_losses=[r["bf16"]["losses"][0] for r in ranks])
    log(f"{tag}: logits, loss ({want['loss']:.6f}) and launches "
        f"{ {k: v for k, v in want['counts'].items() if v} } equal to the "
        f"single device's on each rank; gathered gradients "
        f"{out['gradients']}; updates {out['updates']}; codes flipped "
        f"{out['code_flips']}; three steps' losses {steps['losses']} "
        f"(ranks {[r['steps']['losses'] for r in ranks]}), step ms single "
        f"{[round(t, 2) for t in steps['step_ms']]}, ranks "
        f"{[[round(t, 2) for t in r['steps']['step_ms']] for r in ranks]}; "
        f"peak above held single {max(steps['peak_bytes'])} B, ranks "
        f"{[max(r['steps']['peak_bytes']) for r in ranks]} B; bf16 "
        f"{out['bf16_losses']}"
        + ("; every planted fault seen" if faults else ""))
    del model, step
    torch.cuda.empty_cache()
    return out


def _tp_clip_reference(ranks):
    """R at tp=2 under ``max_grad_norm`` against the single device (same
    weights, biases random, batches, generators): clipping active on every
    step on both; each rank's norm the single device's (TOL, relative);
    the gathered clipped gradients within TP_GRAD_RTOL, the three steps'
    losses within PARALLEL_LOSS_RTOL and their gathered updates within
    TP_UPDATE_RTOL; TP_CLIP_FAULT's run outside one of those bounds."""
    from fewbit_tpu_torch.parallel import gather_tp_params

    path, tag = "roberta_fused_ffn", "parallel roberta_fused_ffn tp=2 clip"
    model, step = _model(path, torch.float32, True,
                         train=dict(TP_TRAIN, max_grad_norm=TP_CLIP_NORM),
                         **NO_DROPOUT)
    _random_biases(model)
    want = _clip_run(path, model, step, "parallel single-device clip f32")
    del model, step
    torch.cuda.empty_cache()
    sound = [r["sound"] for r in ranks]
    norms = [want["norm"], *want["norms"]]
    for r in sound:
        got = [r["norm"], *r["norms"]]
        if not (len(got) == len(norms) == 4
                and min(got + norms) > TP_CLIP_NORM
                and all(abs(a - b) <= TOL[torch.float32] * b
                        for a, b in zip(got, norms))):
            raise AssertionError(f"{tag}: norms {got} against the single "
                                 f"device's {norms}, max {TP_CLIP_NORM}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["steps"]["losses"],
                                                    want["steps"]["losses"])]
        if not max(rel) <= PARALLEL_LOSS_RTOL:
            raise AssertionError(f"{tag}: step losses {r['steps']} vs "
                                 f"{want['steps']['losses']}")
    out = {"max_grad_norm": TP_CLIP_NORM, "norms": norms,
           "rank_norms": [[r["norm"], *r["norms"]] for r in sound],
           "gradients": _grads_close(
               f"{tag} gathered clipped gradients",
               gather_tp_params([r["grads"] for r in sound]), want["grads"],
               TP_GRAD_RTOL),
           "updates": _grads_close(
               f"{tag} gathered updates of the three steps",
               gather_tp_params([r["updates"] for r in sound]),
               want["updates"], TP_UPDATE_RTOL)}
    runs = [r[TP_CLIP_FAULT] for r in ranks]
    grads = gather_tp_params([r["grads"] for r in runs])
    updates = gather_tp_params([r["updates"] for r in runs])
    g_err = _rel_errors(grads, {n: want["grads"][n] for n in grads})[0]
    u_err = _rel_errors(updates, {n: want["updates"][n] for n in updates})[0]
    reading = {"rank_norms": [[r["norm"], *r["norms"]] for r in runs],
               "grads_max_rel_err": g_err[0], "grads_worst": g_err[1],
               "updates_max_rel_err": u_err[0], "updates_worst": u_err[1],
               "seen": g_err[0] > TP_GRAD_RTOL or u_err[0] > TP_UPDATE_RTOL}
    log(f"{tag}, planted fault '{TP_CLIP_FAULT}': {reading}")
    if not reading["seen"]:
        raise AssertionError(f"{tag}: the checks pass the planted fault "
                             f"'{TP_CLIP_FAULT}'")
    out["faults"] = {TP_CLIP_FAULT: reading}
    log(f"{tag}: max_grad_norm {TP_CLIP_NORM}, norms single {norms}, ranks "
        f"{out['rank_norms']}; clipped gradients {out['gradients']}; "
        f"updates {out['updates']}; losses single {want['steps']['losses']}"
        f"; the planted fault seen")
    return out


def _dp_reference(ranks):
    """dp=2 against one process: R's gradient equals the mean of the two
    half-batch gradients, each taken with its rank's folded generator;
    GPT's loss on unequal valid tokens equals the full batch's."""
    from fewbit_tpu_torch.parallel import fold_shard_generator

    path = "roberta_fused_ffn"
    model, step = _model(path, torch.float32, True)
    batch = next(_batches(path, SEED))
    grads, losses = [], []
    for r in range(TP):
        half = {k: v.chunk(TP)[r] for k, v in batch.items()}
        losses.append(step.loss_and_grads(half, fold_shard_generator(
            torch.Generator().manual_seed(SEED), r)).item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    mean = {n: (grads[0][n] + grads[1][n]) / 2 for n in grads[0]}
    del grads, model, step
    got = [r["dp"][path] for r in ranks]
    for name in mean:
        if not torch.equal(got[0]["grads"][name], got[1]["grads"][name]):
            raise AssertionError(f"parallel dp=2: the ranks' {name} differ")
    err = _grads_close(f"parallel dp=2 {path} gradients", got[0]["grads"],
                       mean)
    want_loss = sum(losses) / TP
    lm_model, lm_step = _model("gpt2_small", torch.float32, True,
                               **NO_DROPOUT)
    lm_loss = lm_step.loss_and_grads(_lm_unequal_batch(),
                                     torch.Generator().manual_seed(SEED))
    out = {"roberta_gradients": err,
           "roberta_loss": [g["loss"] for g in got],
           "roberta_half_losses": losses, "gpt_full_batch_loss": lm_loss.item(),
           "gpt_rank_losses": [r["dp"]["gpt2_small"]["loss"] for r in ranks]}
    del lm_model, lm_step
    torch.cuda.empty_cache()
    for g in got:
        if abs(g["loss"] - want_loss) > TOL[torch.float32] * want_loss:
            raise AssertionError(f"parallel dp=2: loss {out}")
    for loss in out["gpt_rank_losses"]:
        if abs(loss - lm_loss.item()) > TOL[torch.float32] * lm_loss.item():
            raise AssertionError(f"parallel dp=2 gpt: loss {out}")
    log(f"parallel dp=2: {path} gradients against the mean of the "
        f"half-batch gradients {err} (the ranks equal to the bit), loss "
        f"{out['roberta_loss']} vs {want_loss:.6f}; GPT-2 small with "
        f"{int((_lm_unequal_batch()['labels'] >= 0).sum())} valid tokens, "
        f"unequal over the ranks: loss {out['gpt_rank_losses']} vs the full "
        f"batch's {lm_loss.item():.6f}")
    return out


def phase_parallel():
    """Data and tensor parallelism on the one card: NCCL at world size 1
    (dp=1 x tp=1, bitwise against the plain step); then two ranks, gloo
    with CUDA tensors: R and G at tp=2 against the single device, R and
    GPT at dp=2; the residual bytes of one tp rank.  Returns (summary,
    each tp path's launches on rank 0 over its three steps)."""
    out = {"nccl_world_of_one": _nccl_world_of_one()}
    log("parallel: two ranks on one card over gloo with CUDA tensors (NCCL "
        "cannot put two ranks on one device); gloo stages each all-reduce "
        "through the host, so these step times say nothing of NCCL over "
        "NVLink")
    with tempfile.TemporaryDirectory() as workdir:
        out["rank_seconds"] = _spawn_ranks(workdir)
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                            weights_only=False) for r in range(TP)]
    counts = {}
    for path in TP_PATHS + TP_FLASH_PATHS:
        out[f"tp2_{path}"] = _tp_reference(path, [r[path] for r in ranks])
        counts[f"tp2_{path}"] = ranks[0][path]["step_counts"]
    out["tp2_roberta_clip"] = _tp_clip_reference([r["clip"] for r in ranks])
    counts["tp2_roberta_clip"] = ranks[0]["clip"]["sound"]["step_counts"]
    out["residuals_tp2"] = ranks[0]["roberta_fused_ffn"]["residuals"]
    out["dp2"] = _dp_reference(ranks)
    return out, counts



# ---------------------------------------------------------------------------
# The examples (phase_examples): the twins of examples/*.py at their own
# widths, and their kernels at those widths.
# ---------------------------------------------------------------------------

CORPUS = "/usr/share/common-licenses"
EX_STEPS = 3
# The kernels at the examples' shapes: (rows N, hidden, FFN width, dtypes,
# cases).  N = 2048, 128 <-> 512: convergence (RoBERTa 4L/128H, bs 32 x seq
# 64; kernel 1 on every projection of the randomized row, 2 and 3 on row 5,
# 6 and 5 on the gelu rows).  N = 4096, 128 <-> 512: lm (GPT 4L/128H, bs 32
# x seq 128, f32 and --dtype bfloat16: kernel 1, 6 and 5) and
# classification (RoBERTa, unfused FFN: kernel 1, 4 and 5); kernels 2 and 3
# there too, which no example runs at 4096 rows.  N = 2048, 768 <-> 3072:
# finetune at RoBERTa-base width (bs 16 x seq 128: kernel 1 at 768 -> 768,
# 2 and 3, 6 and 5).
EX_SHAPES = (
    (2048, 128, 512, (torch.float32,), ("k1", "k23", "k6")),
    (4096, 128, 512, (torch.float32, torch.bfloat16), ("k1", "k6")),
    (4096, 128, 512, (torch.float32,), ("k4", "k23")),
    (2048, 768, 3072, (torch.float32,), ("k1", "k23", "k6")),
)
# Launches of one training step and of one evaluation forward, per row of
# each example; every other kernel 0.  Kernel 1 takes a countsketch
# projection (forward, and backward with the column sum) whose widths are
# at most 1024 and whose rows divide into its buckets: every projection of
# the 4-layer models (q, k, v, output, and the FFN's two where they are
# projections of their own), never the heads' 32 or 16 rows.  The fused
# FFN of a gelu row with a countsketch is kernels 2 and 3; without a
# sketch (or with gaussian) it is kernel 6 and 5; the unfused one is
# kernels 4 and 5.  An evaluation forward launches the forward kernels.
L4 = 4
EX_LAUNCHES = {
    "convergence": {
        "exact": ({}, {}),
        "gelu 3-bit": ({"dense_act": L4, "fused_backward": L4},
                       {"dense_act": L4}),
        "gelu 1-bit": ({"dense_act": L4, "fused_backward": L4},
                       {"dense_act": L4}),
        "randomized 20%": ({"matmul_input_sketch": 12 * L4},
                           {"matmul_input_sketch": 6 * L4}),
        "gelu 3-bit + rand 20%": (
            {"matmul_input_sketch": 8 * L4, "dense_act_sketch": L4,
             "matmul_lut_backward": L4},
            {"matmul_input_sketch": 4 * L4, "dense_act_sketch": L4}),
    },
    "lm": {
        "exact": ({}, {}),
        "gelu 3-bit": ({"dense_act": L4, "fused_backward": L4},
                       {"dense_act": L4}),
        "randomized 20% (countsketch)": ({"matmul_input_sketch": 12 * L4},
                                         {"matmul_input_sketch": 6 * L4}),
        # The structured sketch has no kernel.
        "randomized 20% (srht)": ({}, {}),
        "gelu 3-bit + rand 20%": (
            {"matmul_input_sketch": 10 * L4, "dense_act": L4,
             "fused_backward": L4},
            {"matmul_input_sketch": 5 * L4, "dense_act": L4}),
    },
    "classification": {
        "exact": ({}, {}),
        "gelu 3-bit": ({"fused_forward": L4, "fused_backward": L4},
                       {"fused_forward": L4}),
        "randomized 20% (countsketch)": ({"matmul_input_sketch": 12 * L4},
                                         {"matmul_input_sketch": 6 * L4}),
        "gelu 3-bit + rand 20%": (
            {"matmul_input_sketch": 12 * L4, "fused_forward": L4,
             "fused_backward": L4},
            {"matmul_input_sketch": 6 * L4, "fused_forward": L4}),
    },
    # RoBERTa-base, 3 bits, ratio 0.2: the gaussian sketch never takes
    # kernel 1; the countsketch's ffn_output is inside the fused FFN.
    "finetune": {
        "gaussian": ({"dense_act": 12, "fused_backward": 12},
                     {"dense_act": 12}),
        "countsketch": ({"matmul_input_sketch": 96, "dense_act_sketch": 12,
                         "matmul_lut_backward": 12},
                        {"matmul_input_sketch": 48, "dense_act_sketch": 12}),
    },
}
# memory_profile --time at 2^24 elements: kernel 4 once for each few-bit
# function of the bytes table (relu, hardtanh, gelu/silu/tanh at bits 1-4),
# and once for each call the timer makes (2 to warm up, 3 x 20).
MP_LAUNCHES = {"fused_forward": 2 + 3 * 4 + 2 + 3 * 20}


def _k4_case(results, spec, borders, h, tag, tol, label):
    """Kernel 4 on ``h`` into outputs filled with NaN against its plain
    version (codes equal), with its device time and share of the bound.
    Returns its codes."""
    from fewbit_tpu_torch.ops import kernels as K

    args = (spec, h, borders)
    want = K.act_forward_plain(*args)
    y, packed4 = K.fused_forward(*args, out=_nan_like(*want))
    if not torch.equal(packed4, want[1]):
        raise AssertionError(f"k4 {label} {tag}: packed codes differ")
    # Per element: one compare per border and the GELU.
    least = bound(h.numel() * (spec.n_borders + 1), "simt",
                  tensor_bytes(args, y, packed4))
    case = {"mode": f"{label} forward {tuple(h.shape)}", "dtype": tag,
            "errors": {"y": compare(f"k4 {label} {tag} y", y, want[0], tol),
                       "code_flips": 0},
            "ms": cuda_ms(lambda: K.fused_forward(*args)),
            **device_time(lambda: K.fused_forward(*args), least["bound_ms"]),
            "plain_ms": cuda_ms(lambda: K.act_forward_plain(*args)),
            **least,
            "library_ms": None}
    case["bound_share"] = case["bound_ms"] / case["device_ms"]
    results["fused_forward"].append(case)
    return packed4


def _shape_kernel_cases(shapes, name, seed):
    """Each kernel of a phase's paths at their shapes (``shapes``, as
    ``EX_SHAPES``) against its plain version, into outputs filled with NaN,
    with its device time beside its bound; ``name`` starts the cases'
    labels."""
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.functional.linear import calc_proj_dim
    from fewbit_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec, borders, levels = resolve_activation("gelu", bits=3, device=dev)
    results = {name: [] for name in K.KERNELS}

    def rand(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    for n, hidden, inner, dtypes, kinds in shapes:
        label = f"{name} N={n}"
        k = calc_proj_dim(n, 0.2)
        sigma = torch.randint(0, 2, (n,), generator=gen,
                              device=dev).float() * 2 - 1
        for dt in dtypes:
            tag = "f32" if dt == torch.float32 else "bf16"
            tol = TOL[dt]
            x, g = rand(n, hidden, dt=dt), rand(n, hidden, dt=dt)
            if "k1" in kinds:
                widths = ([(hidden, hidden)] if hidden == HIDDEN else
                          [(hidden, hidden), (hidden, inner),
                           (inner, hidden)])
                for kdim, m in widths:
                    k_eff = K.matmul_sketch_keff(n, kdim, m, k, dt)
                    if k_eff is None or k_eff != K.matmul_sketch_keff(
                            n, m, kdim, k, dt):
                        raise AssertionError(f"k1 {label} {kdim}->{m}: "
                                             f"outside the envelope")
                    w = rand(m, kdim, scale=kdim ** -0.5, dt=dt)
                    _k1_case(results, f"{label} forward {kdim}->{m}", tag,
                             ("y", "sketch"),
                             (rand(n, kdim, dt=dt), w.t(),
                              rand(m, scale=0.1, dt=dt), sigma, k_eff), tol)
                    _k1_case(results, f"{label} backward+colsum {m}->{kdim}",
                             tag, ("dx", "sketch", "colsum"),
                             (rand(n, m, dt=dt), w, None, sigma, k_eff,
                              True), tol)
            up_w = rand(inner, hidden, scale=hidden ** -0.5, dt=dt)
            up_b = rand(inner, scale=0.1, dt=dt)
            if "k23" in kinds:
                _k23_cases(results, spec, borders, levels, sigma,
                           K.countsketch_aligned_keff(n, k), x, g, up_w,
                           up_b, rand(hidden, inner, scale=inner ** -0.5,
                                      dt=dt), tag, tol, label)
            if "k6" in kinds:
                packed = _k6_case(results, spec, borders, x, up_w, up_b, tag,
                                  tol, label)
                _k5_case(results, spec, levels, packed,
                         rand(n, inner, dt=dt), tag, tol, label,
                         "codes of kernel 6")
            if "k4" in kinds:
                packed = _k4_case(results, spec, borders,
                                  rand(n, inner, scale=1.5, dt=dt), tag, tol,
                                  label)
                _k5_case(results, spec, levels, packed,
                         rand(n, inner, dt=dt), tag, tol, label,
                         "codes of kernel 4")
    for cases in results.values():
        for c in cases:
            c["path_shape"] = False
    _log_cases(results)
    torch.cuda.empty_cache()
    return results


def _expect(tag, counts, want):
    """``counts`` (every kernel's) must be ``want``'s, 0 elsewhere."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{tag}: launches "
                             f"{ {k: v for k, v in counts.items() if v} }, "
                             f"expected {want}")


def _scaled(per, times, into):
    for name, v in per.items():
        into[name] = into.get(name, 0) + v * times
    return into


def _ex_probe(twin, row, step, batch, evaluate):
    """One training step of an example's row and one evaluation forward,
    each with every count set to 0 just before it: their launches must be
    ``EX_LAUNCHES``'.  Returns the step's loss."""
    from fewbit_tpu_torch.examples._common import step_generator

    per_step, per_eval = EX_LAUNCHES[twin][row]
    loss, counts = _launched(lambda: step(batch, step_generator(0, 0))[
        "loss"].item())
    _expect(f"{twin} {row} step", counts, per_step)
    if not np.isfinite(loss):
        raise AssertionError(f"{twin} {row}: loss {loss}")
    _, counts = _launched(evaluate)
    _expect(f"{twin} {row} evaluation", counts, per_eval)
    log(f"examples {twin} {row}: a step launches {per_step or 'nothing'}, "
        f"an evaluation forward {per_eval or 'nothing'}; loss {loss:.6f}")
    return loss


def _ex_main(twin, main, argv, evals):
    """An example's ``main(argv)`` with every count set to 0 just before
    it: every row's losses finite, and the launches ``EX_STEPS`` steps and
    ``evals[row]`` evaluation forwards of each row make.  Returns (rows,
    counts)."""
    rows, counts = _launched(lambda: main(argv))
    want = {}
    for r in rows:
        per_step, per_eval = EX_LAUNCHES[twin][r["config"]]
        seeds = r.get("seeds", 1)
        _scaled(per_step, EX_STEPS * seeds, want)
        _scaled(per_eval, evals * seeds, want)
        if not np.isfinite(r["final_loss"]):
            raise AssertionError(f"{twin} {argv}: {r}")
    _expect(f"{twin} main {argv}", counts, want)
    log(f"examples {twin} {' '.join(argv)}: {json.dumps(rows)}")
    return rows, counts


def _corpus():
    """The corpus directory's regular files and bytes, printed; None when
    it is not there."""
    if not os.path.isdir(CORPUS):
        log(f"examples: {CORPUS} is missing: the real-text examples are "
            f"left out")
        return None
    files = [os.path.join(CORPUS, f) for f in sorted(os.listdir(CORPUS))]
    files = [p for p in files if os.path.isfile(p) and not os.path.islink(p)]
    out = {"files": len(files),
           "bytes": sum(os.path.getsize(p) for p in files)}
    log(f"examples: corpus {CORPUS}: {out['files']} files, {out['bytes']} "
        f"bytes")
    return out


def _ex_parity():
    """convergence, lm (f32 and bf16) and classification (doc with a 2-step
    pretrain, and pair): every row probed, then each ``main`` at EX_STEPS.
    Returns (summary, counts by path)."""
    from fewbit_tpu_torch.examples import classification_parity_real_text as CL
    from fewbit_tpu_torch.examples import convergence_parity as CP
    from fewbit_tpu_torch.examples import lm_parity_real_text as LM
    from fewbit_tpu_torch.examples._common import mean_accuracy, on_device

    dev = torch.device("cuda")
    out, counts = {}, {}
    for name, gb, pr in CP.CONFIGS:
        cfg = CP.model_config(gb, pr)
        data, _, held = CP.make_data(cfg)
        model, step = CP.build(cfg, EX_STEPS, dev)
        _ex_probe("convergence", name, step, on_device(next(data), dev),
                  lambda: mean_accuracy(model, held[:1], dev))
    out["convergence"], counts["examples_convergence"] = _ex_main(
        "convergence", CP.main, ["--steps", str(EX_STEPS)], 8)
    if _corpus() is None:
        return out, counts
    _, _, held = LM.make_data()
    for dtype in ("float32", "bfloat16"):
        for name, gb, pr, sk in LM.CONFIGS:
            cfg = LM.model_config(gb, pr, sk, dtype=dtype)
            data, _, _ = LM.make_data()
            model, step = LM.build(cfg, EX_STEPS, dev)
            _ex_probe("lm", name, step, on_device(next(data), dev),
                      lambda: LM.bits_per_byte(model, held[:1], dev))
        tag = "" if dtype == "float32" else "_bf16"
        out["lm" + tag], counts["examples_lm" + tag] = _ex_main(
            "lm", LM.main, ["--steps", str(EX_STEPS), "--dtype", dtype],
            len(held))
    for task, extra in (("doc", ["--pretrain", "2"]), ("pair", [])):
        train, val, n_cls = CL.task_data(task)
        held = CL.val_batches(val, 32)
        for name, bits, ratio, sketch in CL.CONFIGS:
            cfg = CL.model_config(n_cls, bits, ratio, sketch or "countsketch")
            stream, _ = CL.train_stream(train, 32)
            model, step = CL.build(cfg, EX_STEPS, dev)
            _ex_probe("classification", name, step,
                      on_device(next(stream), dev),
                      lambda: mean_accuracy(model, held[:1], dev))
        key = f"classification_{task}"
        out[key], counts["examples_" + key] = _ex_main(
            "classification", CL.main,
            ["--task", task, "--steps", str(EX_STEPS), *extra], len(held))
    del model, step
    torch.cuda.empty_cache()
    return out, counts


FT_ROWS = {"gaussian": ["--num-bits", "3", "--proj-dim-ratio", "0.2"],
           "countsketch": ["--num-bits", "3", "--proj-dim-ratio", "0.2",
                           "--matmul", "countsketch"],
           "vanilla": []}


def _glue_fixture(path, seq=128, vocab=50265):
    """A tokenized MRPC-shaped npz in ``load_tokenized_npz``'s schema: 64
    train and 56 validation rows of RoBERTa's vocabulary, padded."""
    rng = np.random.RandomState(SEED + 16)
    arrays = {}
    for split, n in (("train", 64), ("validation", 56)):
        ids = rng.randint(3, vocab, size=(n, seq)).astype(np.int32)
        mask = np.ones((n, seq), np.int32)
        for i, m in enumerate(rng.randint(seq // 4, seq + 1, size=n)):
            ids[i, m:], mask[i, m:] = 1, 0
        ids[:, 0] = 0
        arrays[f"{split}_input_ids"] = ids
        arrays[f"{split}_attention_mask"] = mask
        arrays[f"{split}_labels"] = rng.randint(0, 2, n).astype(np.int32)
    np.savez(path, **arrays)
    return path


def _ex_finetune(tmp, turns=4):
    """finetune_glue at RoBERTa-base width, bs 16 x seq 128, f32, gaussian
    and countsketch at 3 bits / 0.2: a probed step and evaluation forward;
    ``finetune`` with ``--glue`` on a fixture, ``--log-dir`` (then
    ``summarize_runs``) and ``--checkpoint-dir``, its launches counted;
    the checkpoint restored into a fresh model, whose next step must equal
    the uninterrupted run's to the bit (deterministic mode); then vanilla
    against each few-bit configuration in turns.  Returns (summary, counts
    by path)."""
    from fewbit_tpu_torch.examples import finetune_glue as FG
    from fewbit_tpu_torch.examples._common import on_device, step_generator
    from fewbit_tpu_torch.tools import summarize_runs as SR
    from fewbit_tpu_torch.train import restore_checkpoint

    dev = torch.device("cuda")
    npz = _glue_fixture(os.path.join(tmp, "mrpc.npz"))
    out, counts = {}, {}
    for name in ("gaussian", "countsketch"):
        logs, ckpt = (os.path.join(tmp, d, name) for d in ("logs", "ckpt"))
        argv = [*FT_ROWS[name], "--steps", str(EX_STEPS), "--eval-every",
                "1", "--glue", npz, "--log-dir", logs, "--checkpoint-dir",
                ckpt]
        args = FG.parse_args(argv)
        cfg = FG.model_config(args)
        data, batch0, held = FG.make_data(args, cfg)
        model, step = FG.build(args, cfg)
        _ex_probe("finetune", name, step, on_device(next(data), dev),
                  lambda: FG.accuracy(model, args, batch0, held[:1]))
        del model, step
        run, launched = _launched(lambda: FG.finetune(args))
        # An evaluation after every step and a final one, each over the
        # fixture's 3 validation batches of 16 (the last 8 rows dropped).
        per_step, per_eval = EX_LAUNCHES["finetune"][name]
        _expect(f"finetune {name}", launched, _scaled(
            per_eval, 3 * (EX_STEPS + 1), _scaled(per_step, EX_STEPS, {})))
        counts[f"examples_finetune_{name}"] = launched
        summary = SR.main([logs])
        if [r["param"] for r in summary] != ["gelu3-rand20%"]:
            raise AssertionError(f"summarize_runs {name}: {summary}")
        batch = on_device(next(run["data"]), dev)
        with _deterministic():
            want = run["step"](batch, step_generator(0, EX_STEPS))[
                "loss"].item()
            del run
            torch.cuda.empty_cache()
            model, step = FG.build(args, cfg)
            restored = restore_checkpoint(os.path.join(ckpt, "final"), model,
                                          step)
            got = step(batch, step_generator(0, EX_STEPS))["loss"].item()
        log(f"examples finetune {name}: checkpoint after step {restored}, "
            f"next step {got} against the uninterrupted {want}")
        if restored != EX_STEPS or got != want:
            raise AssertionError(f"finetune {name} checkpoint: {got} != "
                                 f"{want} (step {restored})")
        del model, step
        torch.cuda.empty_cache()
        out[name] = {"rows": summary, "next_step_loss": got}
    for name in ("gaussian", "countsketch"):
        pair = {}
        for which in ("vanilla", name):
            args = FG.parse_args(FT_ROWS[which])
            pair[which] = FG.build(args, FG.model_config(args))[1]
        # The fine-tune's synthetic MRPC-shaped stream, the same for both.
        batches = (on_device(b, dev)
                   for b in FG.make_data(args, FG.model_config(args))[0])
        gen = torch.Generator().manual_seed(SEED)
        for which in pair:  # the optimizer state is held before the turns
            pair[which](next(batches), gen)
        out[f"{name}_turns"] = _vanilla_vs_fewbit(
            f"finetune {name}", {"vanilla": pair["vanilla"],
                                 "fewbit": pair[name]},
            batches, gen, turns)
        del pair
        torch.cuda.empty_cache()
    return out, counts


def _ex_memory_profile():
    """memory_profile --time at 2^24 elements: the bytes table against the
    bytes its shapes imply (codes (bits, 16384 / 32, 1024) int32 and the
    2^bits f32 levels; exact: one f32 tensor), the two GELU times per call
    and, beside them, on the device (the profiler)."""
    import fewbit_tpu_torch.functional as F
    from fewbit_tpu_torch.examples import memory_profile as MP

    rows, counts = _launched(lambda: MP.main(["--time"]))
    _expect("memory_profile", counts, MP_LAUNCHES)
    n = 1 << 24
    for r in rows[:-1]:
        want = r["bits"] * (n // 32) * 4 + 4 * 2 ** r["bits"]
        if r["residual"] * n != want or r["exact"] != 4.0:
            raise AssertionError(f"memory_profile {r}: expected {want} B")
    x = torch.randn(n // 1024, 1024, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    # Bytes bounds: x read and y written, and the few-bit codes.
    exact = bound(0, "simt", 2 * x.numel() * 4)["bound_ms"]
    fewbit = bound(0, "simt", 2 * x.numel() * 4
                   + 3 * (x.shape[0] // 32) * x.shape[1] * 4)["bound_ms"]
    with torch.no_grad():
        rows[-1]["vanilla_device_ms"] = device_ms(
            lambda: MP.EXACT["gelu"](x), exact)
        rows[-1]["fewbit_device_ms"] = device_ms(lambda: F.gelu(x, bits=3),
                                                 fewbit)
    log(f"examples memory_profile: {json.dumps(rows)}")
    return rows, counts


def phase_examples():
    """The examples (``fewbit_tpu_torch/examples``, ``python3 chip_smoke.py
    --examples``): the corpus; each kernel at the examples' shapes against
    its plain version; every row of convergence, lm and classification
    probed and each ``main`` run at EX_STEPS; finetune_glue at full width;
    memory_profile --time.  Returns (summary, counts by path, cases)."""
    results = _shape_kernel_cases(EX_SHAPES, "examples", SEED + 15)
    summary, counts = _ex_parity()
    with tempfile.TemporaryDirectory() as tmp:
        summary["finetune"], ft_counts = _ex_finetune(tmp)
    counts.update(ft_counts)
    summary["memory_profile"], counts["examples_memory_profile"] = (
        _ex_memory_profile())
    return summary, counts, results


# ---------------------------------------------------------------------------
# The long-sequence rows (phase_longseq): the twin of tools/bench_longseq.py
# at seq 2048 and 4096, and the kernels at their shapes.
# ---------------------------------------------------------------------------

# (family, batch, seq), f32: GPT-2 small at 2 x 2048 and 1 x 4096 (4096
# rows each), RoBERTa-base at 4 x 2048 (8192 rows).
LONGSEQ_ROWS = (("gpt", 2, 2048), ("gpt", 1, 4096), ("roberta", 4, 2048))
# Kernels 1, 6 and 5 at GPT's 4096 rows.  RoBERTa's 8192 rows are the
# kernel phase's N: kernels 1, 2 and 3 are held there at 768 <-> 3072.
LONGSEQ_SHAPES = ((4096, HIDDEN, FFN, (torch.float32,), ("k1", "k6")),)
# F1-F3 at the rows' attention: (label, batch, seq, causal); RoBERTa with
# its padding mask as segment ids.
LONGSEQ_FLASH = (("gpt2_small seq 2048", 2, 2048, True),
                 ("gpt2_small seq 4096", 1, 4096, True),
                 ("roberta seq 2048", 4, 2048, False))


def _longseq_launches(family, config):
    """A long-sequence configuration's launches per step: none for
    vanilla; the few-bit path's kernels (GPT-2 small's 1, 6, 5; RoBERTa's
    1, 2, 3); F1-F3 12 each with flash (``"auto"`` takes it at seq >=
    1024 with attention dropout 0)."""
    from fewbit_tpu_torch.tools.bench_longseq import CONFIGS

    c = CONFIGS[config]
    out = dict(PATHS["gpt2_small" if family == "gpt" else
                     "roberta_fused_ffn"]) if c["bits"] else {}
    if c["flash"]:
        out.update(FLASH)
    return out


def _longseq_kernel_cases():
    """Kernels 1, 6, 5 at GPT's 4096 rows, and F1-F3 at the rows'
    attention shapes, each against its plain version (F1-F3 also against
    f64 and beside ``scaled_dot_product_attention``)."""
    from fewbit_tpu_torch.train import synthetic_glue

    results = _shape_kernel_cases(LONGSEQ_SHAPES, "longseq", SEED + 19)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    dt = torch.float32
    for label, b, s, causal in LONGSEQ_FLASH:
        if causal:
            ids = torch.ones(b, s, dtype=torch.int32, device=dev)
        else:
            ids = torch.from_numpy(next(synthetic_glue(b, s, seed=SEED))[
                "attention_mask"]).to(device=dev, dtype=torch.int32)
        q, k, v, do = (torch.randn(b, s, HEADS, HEAD_DIM, generator=gen,
                                   device=dev).transpose(1, 2)
                       for _ in range(4))
        _flash_case(results, "f32", label, q, k, v, do, ids, causal, TOL[dt])
        del q, k, v, do
        torch.cuda.empty_cache()
    for name in FLASH:
        for c in results[name]:
            c["path_shape"] = False
    _log_cases({name: results[name] for name in FLASH})
    return results


def _longseq_row(family, batch, seq):
    """One row through the twin's ``main``, every count set to 0 just
    before it: every configuration fits (each was measured to fit on the
    80 GB card, so an OOM row is a failure here); its launches per step
    as ``_longseq_launches`` says, the total those of its steps, every
    loss finite; the few-bit peak below vanilla's, with and without
    flash.  Returns (its JSON object, counts)."""
    from fewbit_tpu_torch.tools import bench_longseq as BL

    tag = f"longseq {family} {batch} x {seq}"
    argv = ["--family", family, "--batch", str(batch), "--seq", str(seq)]
    out, counts = _launched(lambda: BL.main(argv))
    want, peaks = {}, {}
    if [row["config"] for row in out["rows"]] != list(BL.CONFIGS):
        raise AssertionError(f"{tag}: rows {out['rows']}")
    for row in out["rows"]:
        if "error" in row:
            raise AssertionError(f"{tag} {row['config']}: {row['error']}")
        per_step = _longseq_launches(family, row["config"])
        _expect(f"{tag} {row['config']} step",
                {k: row["launches"].get(k, 0) for k in counts}, per_step)
        _scaled(per_step, row["steps"], want)
        if not np.isfinite(row["loss"]):
            raise AssertionError(f"{tag} {row['config']}: {row}")
        peaks[row["config"]] = row["peak_bytes"]
    _expect(f"{tag} main", counts, want)
    for fewbit, vanilla in (("fewbit", "vanilla"),
                            ("fewbit_flash", "vanilla_flash")):
        if not peaks[fewbit] < peaks[vanilla]:
            raise AssertionError(f"{tag}: {fewbit} peak {peaks[fewbit]} >= "
                                 f"{vanilla} {peaks[vanilla]}")
    log(f"{tag}: {json.dumps(out)}")
    return out, counts


def phase_longseq():
    """The long-sequence rows (``python3 chip_smoke.py --longseq``): the
    kernels at their shapes, then each row of LONGSEQ_ROWS through the
    twin of ``tools/bench_longseq.py``.  Returns (summary, counts by row,
    cases)."""
    results = _longseq_kernel_cases()
    summary, counts = {}, {}
    for family, batch, seq in LONGSEQ_ROWS:
        key = f"longseq_{family}_{batch}x{seq}"
        summary[key], counts[key] = _longseq_row(family, batch, seq)
        torch.cuda.empty_cache()
    return summary, counts, results


def main():
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3])
        return
    smi = phase_device()
    if sys.argv[1:] == ["--activations"]:
        phase_activations()
        return
    if sys.argv[1:] == ["--surgery"]:
        log(json.dumps({"surgery": phase_surgery(), "card": smi}))
        return
    if sys.argv[1:] == ["--parallel"]:
        summary, counts = phase_parallel()
        log(json.dumps({"parallel": summary, "launches": counts,
                        "card": smi}))
        return
    if sys.argv[1:] == ["--examples"]:
        summary, counts, _ = phase_examples()
        log(json.dumps({"examples": summary, "launches": counts,
                        "card": smi}))
        return
    if sys.argv[1:] == ["--longseq"]:
        summary, counts, _ = phase_longseq()
        log(json.dumps({"longseq": summary, "launches": counts,
                        "card": smi}))
        return
    if sys.argv[1:2] == ["--profile"]:
        if sys.argv[2:] not in [[path] for path in PATHS]:
            sys.exit(f"chip_smoke: --profile takes one of {list(PATHS)}")
        phase_profile(sys.argv[2])
        return
    results = phase_kernels()
    train, counts = {}, {}
    activations = phase_activations()
    crossover = phase_crossover()
    for path, run in (("roberta_fused_ffn", phase_path),
                      ("gpt2_small", phase_path),
                      ("roberta_unfused_ffn", phase_steps),
                      ("gpt2_small_flash", phase_path),
                      ("roberta_flash", phase_steps),
                      ("roberta_default", phase_path),
                      ("mlp", phase_path)):
        train[path], counts[path] = run(path)
    # The slice's own path; its launches stay in its own summary.
    train["surgery"] = phase_surgery()
    train["parallel"], tp_counts = phase_parallel()
    counts.update(tp_counts)
    train["examples"], ex_counts, ex_results = phase_examples()
    train["longseq"], ls_counts, ls_results = phase_longseq()
    counts.update(ex_counts)
    counts.update(ls_counts)
    for name in results:
        results[name].extend(ex_results[name] + ls_results[name])
    sketch_kinds = phase_sketch_kinds()
    exp_rows, counts["exp_megakernel"] = phase_exp_megakernel()
    from fewbit_tpu_torch.ops import kernels as K

    kernels = []
    for name, cases in results.items():
        _, _, replaces, source = K.KERNELS[name]
        by_path = {path: c[name] for path, c in counts.items() if c[name]}
        if not by_path and name not in NO_PATH:
            raise AssertionError(f"kernel {name}: no path launched it")
        first = next(c for c in cases if c.get("path_shape", True))
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # Over the cases whose outputs are f32.
            "max_abs_err": max(v for c in cases
                               if c["dtype"] in ("f32", "bf16->f32")
                               for k, v in c["errors"].items()
                               if k != "code_flips"),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "cases": cases})
    log(json.dumps({"train": train, "crossover": crossover,
                    "sketch_kinds": sketch_kinds, "activations": activations,
                    "card": smi}))
    log(json.dumps({"exp_megakernel": exp_rows, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
