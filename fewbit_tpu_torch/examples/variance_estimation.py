"""Pick a sketch compression ratio from gradient-variance estimates, as
``examples/variance_estimation.py`` does with the JAX package.

Wraps a ``RandomizedDense`` in a ``VarianceEstimator``, takes one gradient
of a mean square loss at each ratio, and prints the input/gradient
correlation with the SGD and RMM variances: choose the largest compression
whose RMM (sketch) variance stays below the SGD (mini-batch) variance.

    python -m fewbit_tpu_torch.examples.variance_estimation               # the card
    python -m fewbit_tpu_torch.examples.variance_estimation --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from fewbit_tpu_torch.examples._common import add_device_flag, resolve_device

RATIOS = (0.02, 0.05, 0.1, 0.2, 0.5)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from fewbit_tpu_torch.modules import (RandomizedDense, VarianceEstimator,
                                          VarianceEstimatorState)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(parser, args)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2048, 256).astype(np.float32)).to(device)
    target = torch.from_numpy(rng.randn(2048, 64).astype(np.float32)).to(device)

    print(f"{'ratio':>6} {'corr':>8} {'var_sgd':>12} {'var_rmm':>12} "
          f"{'rmm/sgd':>8}")
    rows = []
    for ratio in RATIOS:
        state = VarianceEstimatorState()
        layer = RandomizedDense(256, 64, proj_dim_ratio=ratio, device=device,
                                generator=torch.Generator(
                                    device=device).manual_seed(0))
        wrapped = VarianceEstimator(layer, state)
        y = wrapped(x, torch.Generator(device=device).manual_seed(2))
        torch.mean((y - target) ** 2).backward()
        corr, var_sgd, var_rmm = state.variance
        rows.append({"ratio": ratio, "corr": corr, "var_sgd": var_sgd,
                     "var_rmm": var_rmm})
        print(f"{ratio:>6.2f} {corr:>8.4f} {var_sgd:>12.4e} "
              f"{var_rmm:>12.4e} {var_rmm / var_sgd:>8.3f}")
    return rows


if __name__ == "__main__":
    main()
