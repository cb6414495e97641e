"""The megakernel experiment on the card: four schedules of the fused dense
+ activation + few-bit codes kernel (kernel 6), timed beside the shipped
``fused_dense_act``, the first CUDA-core kernel and the bare matmul.

    python3 -m fewbit_tpu_torch.tools.exp_megakernel [--iters 50]

The counterpart of the JAX package's ``tools/exp_megakernel.py``, at its
shape (N = 8192, K = 768, M = 3072, 3-bit GELU) and with its question:
which schedule of ``act(x @ w)`` with the packed codes of the
pre-activation is fastest, and what the epilogue costs.

  kloop      -- the k tiles through a TMA ring, the accumulator carried
                over them, the epilogue after the last (``make_variant``);
                ``noepi`` is its matmul-only ablation
  direct     -- the weight panel resident in shared memory, a persistent
                block walks the row tiles (``make_direct``), at each panel
                width the envelope admits
  emit       -- direct with y written by TMA stores under the next tile's
                product (``make_emit``)
  pipelined  -- two warpgroups take tiles in turns, one's epilogue under
                the other's product (``make_pipelined``)

in three type pairs: f32 -> f32 (three TF32 products), bf16 -> f32 (the JAX
tool's default rows: bf16 operands, f32 y) and bf16 -> bf16 (its "bf16 e2e"
rows).  x is cast once, before the timing.  The weight is held as an
(out, in) parameter and passed through ``.t()``, as the models pass it.  A
schedule whose envelope does not admit the shape is printed as "outside the
envelope" and not launched.

Each row: milliseconds per call (CUDA events around ``--iters`` calls,
median of ``--rounds`` blocks), TFLOP/s of the product's 2 N K M
operations, and the share of the bound reached, the bound being the least
time the card could take for the row's operations and bytes
(:mod:`fewbit_tpu_torch.tools.timing`).  The bare ``torch.matmul`` rows are
context, as the JAX tool's "XLA matmul" rows: not the same function.

The JAX tool's ``dimension_semantics`` rows, its VMEM block sweep and its
``MXU_PEAK`` are the TPU's and have no counterpart here.

``--device cpu`` runs the plain version of every row at a small size (the
wrappers take it for a CPU tensor); its times are the host's and say
nothing of the card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.tools.timing import bound_ms, gemm_rate, timed

__all__ = ("main", "SHAPE", "CPU_SHAPE")

SHAPE = (8192, 768, 3072)      # N, K, M
CPU_SHAPE = (256, 128, 256)
BITS = 3
TAGS = {(torch.float32, torch.float32): "f32",
        (torch.bfloat16, torch.float32): "bf16->f32",
        (torch.bfloat16, torch.bfloat16): "bf16"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _cases(spec, borders, x, w, out_dtype):
    """The rows of one type pair: ``(name, KERNELS key or None, fn or None
    where the envelope refuses the shape)``."""
    dt = x.dtype
    kdim, m = w.shape
    cases = []
    if out_dtype == dt:
        cases += [
            ("torch.matmul", None, lambda: torch.matmul(x, w)),
            ("shipped fused_dense_act", "dense_act",
             lambda: K.fused_dense_act(spec, x, w, None, borders)),
            ("simt (CUDA cores)", "dense_act_simt",
             lambda: K.dense_act_simt(spec, x, w, None, borders)),
        ]
    else:
        cases.append(("torch.matmul + cast", None,
                      lambda: torch.matmul(x, w).to(out_dtype)))
    bn = K.dense_act_kloop_route(m, dt)
    cases += [
        (f"kloop(128,{bn})", "dense_act_kloop",
         lambda: K.dense_act_kloop(spec, x, w, None, borders, out_dtype)),
        (f"kloop(128,{bn})+noepi", "dense_act_kloop",
         lambda: K.dense_act_kloop(spec, x, w, None, borders, out_dtype,
                                   epilogue=False)),
    ]
    for name, wrapper, route in (
            ("direct", K.dense_act_direct, K.dense_act_direct_route),
            ("emit", K.dense_act_emit, K.dense_act_emit_route)):
        widest = route(kdim, m, dt, out_dtype)
        if widest is None:
            cases.append((name, f"dense_act_{name}", None))
        for bn in K.FG_TILE_N:
            if widest is not None and bn <= widest and m % bn == 0:
                cases.append((
                    f"{name}(128,{bn}) w-resident", f"dense_act_{name}",
                    lambda wrapper=wrapper, bn=bn: wrapper(
                        spec, x, w, None, borders, out_dtype, bn=bn)))
    bn = K.dense_act_pipelined_route(m, dt)
    cases.append((f"pipelined(64,{bn})", "dense_act_pipelined",
                  lambda: K.dense_act_pipelined(spec, x, w, None, borders,
                                                out_dtype)))
    return cases


def main(argv=None):
    """Run the experiment; print one line per row and return the rows, a
    list of dicts (``name``, ``kernel``, ``dtype``, ``status``, for a row
    that ran ``calls``, and on the card ``ms``, ``tflops``, ``bound_ms``,
    ``bound_by``, ``bound_share``; on the CPU ``host_ms`` alone)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shape", type=int, nargs=3, metavar=("N", "K", "M"),
                    default=None, help="default: 8192 768 3072 on the card, "
                    "256 128 256 on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_megakernel: no CUDA device; the schedules "
                           "are CUDA kernels (--device cpu runs their plain "
                           "versions at a small size)")
    dev = torch.device(args.device)
    n, kdim, m = args.shape or (SHAPE if dev.type == "cuda" else CPU_SHAPE)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    spec, borders, _ = resolve_activation("gelu", bits=BITS, device=dev)
    x32 = torch.randn(n, kdim, device=dev,
                      generator=torch.Generator(dev).manual_seed(1))
    w32 = torch.randn(kdim, m, device=dev,
                      generator=torch.Generator(dev).manual_seed(2)) * 0.02
    flops = 2.0 * n * kdim * m
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu: plain versions, host times")
    print(f"exp_megakernel: N={n} K={kdim} M={m}, {BITS}-bit gelu, "
          f"{args.iters} iters x {args.rounds} rounds, {where}", flush=True)
    rows = []
    for (dt, out_dtype), tag in TAGS.items():
        x = x32.to(dt)
        w = w32.to(dt).t().contiguous().t()  # an (out, in) parameter's .t()
        for name, kernel, fn in _cases(spec, borders, x, w, out_dtype):
            row = {"name": f"{name} {tag}", "kernel": kernel, "dtype": tag}
            if fn is None:
                row["status"] = "outside the envelope"
                print(f"{row['name']:44s} outside the envelope", flush=True)
                rows.append(row)
                continue
            out = fn()
            # Each input read once, each output written once.
            nbytes = _nbytes(x, w, *(out if isinstance(out, tuple)
                                     else (out,)))
            ms = timed(fn, args.iters, args.rounds, device=dev)
            row.update(status="ok", calls=1 + 2 + args.iters * args.rounds)
            if dev.type != "cuda":  # the host's time: no device metric
                row["host_ms"] = ms
                print(f"{row['name']:44s} {ms:8.4f} ms on the host",
                      flush=True)
                rows.append(row)
                continue
            bound, by = bound_ms(flops, gemm_rate(dt), nbytes)
            row.update(ms=ms, tflops=flops / ms / 1e9, bound_ms=bound,
                       bound_by=by, bound_share=bound / ms)
            print(f"{row['name']:44s} {ms:8.4f} ms  {row['tflops']:7.1f} "
                  f"TFLOP/s  {100 * row['bound_share']:5.1f}% of the bound "
                  f"({bound:.4f} ms by {by})", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
