"""Operator-level memory and time profile, as ``examples/memory_profile.py``
does with the JAX package.

Per activation function and bit width, the residual bytes per element
that the backward keeps (``estimate_memory_usage``) against the exact
function's; with ``--time``, the exact and the 3-bit few-bit GELU forward
(kernel 4 on the card), each timed by
:func:`fewbit_tpu_torch.tools.timing.timed` (CUDA events on the card, the
host clock on the CPU).

    python -m fewbit_tpu_torch.examples.memory_profile [--time]  # the card
    python -m fewbit_tpu_torch.examples.memory_profile --device cpu

The exact column is what torch's autograd keeps for the exact function
(one f32 tensor, 4 bytes an element); the JAX script's exact column counts
what its VJP closure keeps, which differs by function.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as TF

import fewbit_tpu_torch.functional as F
from fewbit_tpu_torch.examples._common import add_device_flag, resolve_device
from fewbit_tpu_torch.tools.timing import timed
from fewbit_tpu_torch.util import estimate_memory_usage

EXACT = {"relu": torch.relu, "hardtanh": lambda t: torch.clamp(t, -1, 1),
         "gelu": lambda t: TF.gelu(t, approximate="none"),
         "silu": TF.silu, "tanh": torch.tanh}
TIME_ITERS = 20


def memory_rows(x: torch.Tensor) -> List[dict]:
    """``{"function", "bits", "residual", "exact"}`` bytes per element of
    ``x``: relu and hardtanh at 1 bit, gelu, silu and tanh at bits 1-4."""
    n = x.numel()
    rows = []
    for name in ("relu", "hardtanh"):
        rows.append({"function": name, "bits": 1,
                     "residual": estimate_memory_usage(getattr(F, name),
                                                       x) / n,
                     "exact": estimate_memory_usage(EXACT[name], x) / n})
    for name in ("gelu", "silu", "tanh"):
        fn = getattr(F, name)
        exact = estimate_memory_usage(EXACT[name], x) / n
        for bits in (1, 2, 3, 4):
            saved = estimate_memory_usage(lambda t: fn(t, bits=bits), x)
            rows.append({"function": name, "bits": bits,
                         "residual": saved / n, "exact": exact})
    return rows


def gelu_times(x: torch.Tensor) -> dict:
    """Milliseconds per forward call: exact GELU and 3-bit few-bit GELU."""
    with torch.no_grad():
        return {
            "vanilla": timed(lambda: TF.gelu(x, approximate="none"),
                             iters=TIME_ITERS, device=x.device),
            "fewbit3": timed(lambda: F.gelu(x, bits=3), iters=TIME_ITERS,
                             device=x.device)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time", action="store_true",
                        help="also time the GELU forward on the device")
    parser.add_argument("--elems", type=int, default=1 << 24)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(parser, args)

    n = args.elems
    shape = (n // 1024, 1024)
    rows = memory_rows(torch.zeros(shape, device=device))
    print(f"{'function':<12} {'bits':>4} {'residual B/elem':>16} "
          f"{'exact B/elem':>13}")
    for r in rows:
        print(f"{r['function']:<12} {r['bits']:>4} {r['residual']:>16.4f} "
              f"{r['exact']:>13.4f}")

    if args.time:
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(shape, device=device, generator=gen)
        times = gelu_times(x)
        clock = "CUDA events" if device.type == "cuda" else "host clock"
        print(f"\ntimings (ms a call, {clock}, median of 3 x {TIME_ITERS}):")
        print("vanilla gelu fwd:", f"{times['vanilla']:.3f}")
        print("fewbit3 gelu fwd:", f"{times['fewbit3']:.3f}")
        rows.append({"function": "gelu", "bits": 3,
                     "vanilla_ms": times["vanilla"],
                     "fewbit_ms": times["fewbit3"]})
    return rows


if __name__ == "__main__":
    main()
