"""Timing on the card, and the card's published peaks.

``timed`` puts CUDA events around ``iters`` calls of a function and
returns the median over ``rounds`` such blocks, per call: device time with
the host's enqueue hidden behind it wherever the device is the slower of
the two.  On the CPU it reads the host clock instead; such a number is the
CPU's, never a device time.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): bytes per second of device memory,
and operations per second by operand type.  f32 products run as three TF32
products (the port's f32 policy), so their rate is a third of the TF32
peak; elementwise kernels run on the CUDA cores.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ("PEAK_BYTES", "PEAK_OPS", "gemm_rate", "bound_ms", "timed")

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 495e12 / 3, "simt": 67e12}


def gemm_rate(dtype) -> str:
    """The key of ``PEAK_OPS`` for a product of ``dtype`` operands."""
    return "f32" if dtype == torch.float32 else "bf16"


def bound_ms(ops: float, rate: str, nbytes: float):
    """The least milliseconds the card could take for ``ops`` operations at
    ``PEAK_OPS[rate]`` and ``nbytes`` bytes at the memory rate: the larger
    of the two, and which it is (``"operations"`` or ``"bytes"``)."""
    by_ops, by_bytes = ops / PEAK_OPS[rate] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(by_ops, by_bytes),
            "operations" if by_ops >= by_bytes else "bytes")


def timed(fn, iters: int = 50, rounds: int = 3, warmup: int = 2,
          device=None) -> float:
    """Median milliseconds per call of ``fn()`` over ``rounds`` blocks of
    ``iters`` calls, after ``warmup`` calls: ``warmup + rounds * iters``
    calls in all.  CUDA events on a CUDA ``device`` (the default), the host
    clock on the CPU."""
    device = torch.device("cuda" if device is None else device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        blocks = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            blocks.append((time.perf_counter() - t0) * 1e3 / iters)
        return statistics.median(blocks)
    torch.cuda.synchronize(device)
    blocks = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        blocks.append(start.elapsed_time(end) / iters)
    return statistics.median(blocks)
