"""Regenerate the port's builtin LUT archive from scratch, as
``tools/quantize_builtins.py`` does for the JAX package.

Runs the port's own Lloyd-style quantizer
(:func:`fewbit_tpu_torch.approx.approximate`) on closed-form derivatives of
the 13 continuous activations, for 1..4 bits each, on the domain
(-100, 100), with an exact DP fit as the fallback.  The output path is
required; the archive the port loads is
``fewbit_tpu_torch/data/builtin.npz``:

    python -m fewbit_tpu_torch.tools.quantize_builtins \
        fewbit_tpu_torch/data/builtin.npz [--only gelu:3 --only tanh]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.special import erf, expit  # expit = logistic sigmoid

from fewbit_tpu_torch.approx import (Stepwise, approximate, dp_quantize,
                                     estimate_error)

__all__ = ("FUNCS", "dp_fallback", "quantize_one", "main")

SQRT2 = np.sqrt(2.0)
INV_SQRT_2PI = 1.0 / np.sqrt(2.0 * np.pi)

SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805

BITS = (1, 2, 3, 4)

# The JAX package's directory name: this tool writes into no directory of
# that name.
_JAX_PACKAGE = "fewbit_tpu"


def softplus(x):
    return np.logaddexp(0.0, x)


def sech2(x):
    return 1.0 / np.cosh(np.clip(x, -350, 350)) ** 2


# (primal F, derivative f') pairs; the quantizer approximates f' using F for
# exact per-interval means.
FUNCS = {
    "celu": (
        lambda x: np.where(x > 0, x, np.expm1(np.minimum(x, 0.0))),
        lambda x: np.where(x > 0, 1.0, np.exp(np.minimum(x, 0.0))),
    ),
    "elu": (
        lambda x: np.where(x > 0, x, np.expm1(np.minimum(x, 0.0))),
        lambda x: np.where(x > 0, 1.0, np.exp(np.minimum(x, 0.0))),
    ),
    "gelu": (
        lambda x: 0.5 * x * (1.0 + erf(x / SQRT2)),
        lambda x: 0.5 * (1.0 + erf(x / SQRT2))
        + x * INV_SQRT_2PI * np.exp(-0.5 * np.clip(x, -37, 37) ** 2),
    ),
    "hardswish": (
        lambda x: np.where(x <= -3, 0.0,
                           np.where(x >= 3, x, x * (x + 3.0) / 6.0)),
        lambda x: np.where(x <= -3, 0.0,
                           np.where(x >= 3, 1.0, (2.0 * x + 3.0) / 6.0)),
    ),
    "logsigmoid": (
        lambda x: -softplus(-x),
        lambda x: expit(-x),
    ),
    "mish": (
        lambda x: x * np.tanh(softplus(x)),
        lambda x: np.tanh(softplus(x))
        + x * expit(x) * sech2(softplus(x)),
    ),
    "selu": (
        lambda x: SELU_SCALE * np.where(
            x > 0, x, SELU_ALPHA * np.expm1(np.minimum(x, 0.0))),
        lambda x: SELU_SCALE * np.where(
            x > 0, 1.0, SELU_ALPHA * np.exp(np.minimum(x, 0.0))),
    ),
    "sigmoid": (
        lambda x: expit(x),
        lambda x: expit(x) * (1.0 - expit(x)),
    ),
    "silu": (
        lambda x: x * expit(x),
        lambda x: expit(x) * (1.0 + x * (1.0 - expit(x))),
    ),
    "softplus": (
        softplus,
        expit,
    ),
    "softsign": (
        lambda x: x / (1.0 + np.abs(x)),
        lambda x: 1.0 / (1.0 + np.abs(x)) ** 2,
    ),
    "tanh": (
        np.tanh,
        sech2,
    ),
    "tanhshrink": (
        lambda x: x - np.tanh(x),
        lambda x: np.tanh(x) ** 2,
    ),
}


def dp_fallback(fn_prim, fn, bits: int) -> Stepwise:
    """Exact DP on a fine central lattice; outer borders re-extended to the
    full domain with levels re-estimated as exact interval means."""
    dp = dp_quantize(fn, 1 << bits, domain=(-16.0, 16.0), lattice=2048)
    borders = dp.borders.copy()
    borders[0], borders[-1] = -100.0, 100.0
    levels = np.diff(fn_prim(borders)) / np.diff(borders)
    return Stepwise(borders, levels)


def quantize_one(name: str, fn_prim, fn, bits: int) -> Stepwise:
    """The best of the Lloyd fits from seeds 0..15 (the first converged one
    at 2 bits or fewer) and the DP fit, which wins only when its error is
    below 0.999 times the best Lloyd fit's."""
    best = None
    for seed in range(16):
        approx, info = approximate(
            fn=fn, fn_prim=fn_prim, cardinality=1 << bits,
            domain=(-100.0, 100.0), max_iters=5000, beps=1e-6, leps=1e-6,
            random_state=seed)
        if info["status"] != "converged":
            continue
        if not np.all(np.diff(approx.borders) > 0):
            continue
        err, _ = estimate_error(fn, approx, dx=1e-3)
        if best is None or err < best[0]:
            best = (err, approx, seed)
        if bits <= 2 and best is not None:
            break  # low-bit fits are easy; no need to sweep all seeds
    dp_ext = dp_fallback(fn_prim, fn, bits)
    err_dp, _ = estimate_error(fn, dp_ext, dx=1e-3)
    if best is None or err_dp < best[0] * 0.999:
        best = (err_dp, dp_ext, "dp")
    err, approx, seed = best
    print(f"  {name}{bits:02d}: L2^2 err {err:.3e} (seed {seed})", flush=True)
    return approx


def _entry(text: str):
    name, _, bits = text.partition(":")
    if name not in FUNCS:
        raise argparse.ArgumentTypeError(
            f"unknown activation {name!r}; one of {', '.join(FUNCS)}")
    return name, (int(bits),) if bits else BITS


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Writes ``{name}{bits:02d}-{borders|levels}`` float64 arrays to the
    output path and returns them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("output", type=Path)
    ap.add_argument("--only", type=_entry, action="append", default=None,
                    metavar="NAME[:BITS]",
                    help="quantize only these entries (repeatable)")
    args = ap.parse_args(argv)
    out = args.output.resolve()
    if _JAX_PACKAGE in out.parts:
        sys.exit(f"quantize_builtins: refusing to write into the JAX "
                 f"package ({out})")
    entries = args.only or [(name, BITS) for name in FUNCS]
    arrays = {}
    for name, bits_list in entries:
        fn_prim, fn = FUNCS[name]
        print(name, flush=True)
        for bits in bits_list:
            approx = quantize_one(name, fn_prim, fn, bits)
            arrays[f"{name}{bits:02d}-borders"] = approx.borders.astype(
                np.float64)
            arrays[f"{name}{bits:02d}-levels"] = approx.levels.astype(
                np.float64)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    print(f"wrote {len(arrays)} arrays to {out}", flush=True)
    return arrays


if __name__ == "__main__":
    main()
