"""Device time of the few-bit activation kernels per activation id, at the
shapes of the training paths, on the card.

    python3 -m fewbit_tpu_torch.tools.act_timing [--acts gelu relu ...]

For each activation (3-bit builtin LUT for the continuous ones, the 1-bit
predicate for the piecewise ones) and each of f32 and bf16, one JSON line
per kernel with its device milliseconds per call (``device_ms``: the
profiler's sum of the kernels a call launches, over ``REPS`` calls, the
median of three such runs):

  fused_forward      kernel 4 on the (8192, 3072) FFN activation
  dense_act_kloop    kernel 6's k loop at 8192 x 768 -> 3072
  dense_act_sketch   kernel 2 at 8192 x 768 -> 3072, k_eff 2048

Nothing is checked here: ``chip_smoke.py`` holds every id against its
plain version.  The script reads only the wrappers' arguments, so copied
into an older tree it times that tree's kernels (GELU only there), which is
how two trees are compared within one call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

N, K, M, K_EFF = 8192, 768, 3072, 2048
REPS = 20


def _profiled_ms(fn, reps):
    """Device milliseconds per call of one profiled run of ``reps`` calls:
    the sum of the CUDA kernels' times (0.0 when the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps / 1e3


def _event_ms(fn, reps):
    """Milliseconds per call by CUDA events around a loop of ``reps``
    calls: the device's time, or the host's where it is the slower."""
    from fewbit_tpu_torch.tools.timing import timed

    return timed(fn, iters=reps, rounds=1, warmup=0)


def device_time(fn, reps=10, tries=3, bound_ms=None):
    """Device milliseconds of ``fn`` per call and how they were read, as
    ``(ms, source)``.  With ``source == "profiler"`` the time is that of
    the CUDA kernels it launches, summed over a profiled run of ``reps``
    calls (torch.profiler), without the host's share of the call; the
    median of ``tries`` such runs.  A run that reports no device time, or
    less than ``bound_ms`` (the least time the card could take for the
    call's work), has dropped events and is not counted.  When no run
    counts and a bound is given, the call is timed by CUDA events around a
    loop instead, up to ``tries`` times (``source == "events"``: the time
    per call, the host's where it is the slower); if every reading is
    below the bound, it raises.  ``chip_smoke.py`` times its kernels with
    this function too."""
    fn()
    torch.cuda.synchronize()
    floor = 0.0 if bound_ms is None else bound_ms
    runs = [ms for ms in (_profiled_ms(fn, reps) for _ in range(tries))
            if ms > 0 and ms >= floor]
    if runs:
        return statistics.median(runs), "profiler"
    if bound_ms is None:
        raise AssertionError("the profiler saw no device time")
    readings = []
    for _ in range(tries):
        readings.append(_event_ms(fn, reps))
        if readings[-1] >= bound_ms:
            return readings[-1], "events"
    raise AssertionError(f"every reading is below the bound {bound_ms} ms: "
                         f"CUDA events {readings}")


def device_ms(fn, reps=10, tries=3, bound_ms=None):
    """The milliseconds of :func:`device_time` alone."""
    return device_time(fn, reps, tries, bound_ms)[0]


def main(argv=None):
    from fewbit_tpu_torch.functional.activations import resolve_activation
    from fewbit_tpu_torch.ops import kernels as K_

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--acts", nargs="+", default=["gelu"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("act_timing: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        h = (torch.randn(N, M, generator=gen, device=dev) * 1.5).to(dt)
        x = torch.randn(N, K, generator=gen, device=dev).to(dt)
        w = (torch.randn(M, K, generator=gen, device=dev) * K ** -0.5).to(dt)
        b = (torch.randn(M, generator=gen, device=dev) * 0.1).to(dt)
        sigma = torch.randint(0, 2, (N,), generator=gen,
                              device=dev).float() * 2 - 1
        for act in args.acts:
            spec, borders, _ = resolve_activation(act, bits=3, device=dev)
            calls = {
                "fused_forward": lambda: K_.fused_forward(spec, h, borders),
                "dense_act_kloop": lambda: K_.dense_act_kloop(
                    spec, x, w.t(), b, borders),
                "dense_act_sketch": lambda: K_.fused_dense_act_sketch(
                    spec, x, w.t(), b, borders, sigma, K_EFF)}
            for kernel, fn in calls.items():
                row = {"kernel": kernel, "act": act,
                       "dtype": str(dt).replace("torch.", ""),
                       "device_ms": device_ms(fn, REPS)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
